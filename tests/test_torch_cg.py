"""Generic sparse problems through Coo + CG in cosmo_tpu_torch against
cosmo_tpu, on the CPU in float64: the matrix-free CG and MINRES KKT solves
(``ops/kkt.py``) on one system, and whole solves that resolve to
``kkt_solver == "cg"`` — coupled sparse input, the decomposed banded SDP
with the overlap preconditioner, the portfolio QP of the OSQP benchmarks
with re-solves.

The KKT solves are compared to the reference's x, nu and step count; the
solves by status and objective within the stated tolerance, never by
iteration count (ROADMAP.md "How the port is held")."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import kkt as jkkt
from cosmo_tpu.ops import linops as jl
from cosmo_tpu_torch import chordal as tchordal
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.ops import kkt as tkkt
from cosmo_tpu_torch.ops import linops as tl

torch.set_num_threads(1)


def _coo_pair(M):
    """The same scipy matrix as a cosmo_tpu and a cosmo_tpu_torch Coo."""
    M = sp.csr_matrix(M)
    return (jl.coo_from_scipy(M, np.float64),
            tl.coo_to_device(tl.coo_from_scipy(M, np.float64), "cpu", torch.float64))


def _decomposed_system(seed=0):
    """The reduced KKT system of the compact-decomposed banded_sdp(40, 3):
    P, A as Coo in both packages, the overlap structure, and random rho,
    r1, r2, x0 from ``seed``."""
    P, q, A, b, sets, _ = tprob.banded_sdp(40, 3, seed=0, sparse=True)
    info = tchordal.decompose(P, q, A, b, sets, pt.Settings(decompose=True))
    Pd, _, Ad, _, _ = info.problem
    rng = np.random.default_rng(seed)
    m, n = Ad.shape
    vecs = (rng.random(m) + 0.5, rng.standard_normal(n), rng.standard_normal(m),
            0.1 * rng.standard_normal(n))
    return _coo_pair(Pd), _coo_pair(Ad), info, vecs


def _jax_solve(solver, refine_steps, precond, max_iter=250, sched=1e-9):
    (Pj, _), (Aj, _), info, vecs = _decomposed_system()
    args = [jnp.asarray(v) for v in (1e-6, *vecs, sched, np.inf)]
    kw = dict(precond=jkkt.make_overlap_precond(
        info.n_orig, info.ov_child_rows, info.ov_parent_rows)) if precond else {}
    x, nu, k = getattr(jkkt, solver)(Pj, Aj, *args, max_iter, refine_steps, **kw)
    return np.asarray(x), np.asarray(nu), int(k)


def _torch_solve(solver, refine_steps, precond, max_iter=250, sched=1e-9,
                 block=tkkt.CG_BLOCK):
    (_, Pt), (_, At), info, vecs = _decomposed_system()
    args = [torch.as_tensor(v, dtype=torch.float64) for v in (1e-6, *vecs, sched, np.inf)]
    kw = dict(precond=tkkt.make_overlap_precond(
        info.n_orig, info.ov_child_rows, info.ov_parent_rows, device="cpu")
        ) if precond else {}
    x, nu, k, reads = getattr(tkkt, solver)(Pt, At, *args, max_iter, refine_steps,
                                            block=block, **kw)
    return x.numpy(), nu.numpy(), int(k), reads


@pytest.mark.parametrize("solver,refine_steps,precond", [
    ("cg_solve", 0, False), ("cg_solve", 1, False), ("cg_solve", 0, True),
    ("cg_solve", 1, True), ("minres_solve", 0, False), ("minres_solve", 1, False),
], ids=["cg", "cg_restarts", "cg_precond", "cg_precond_restarts", "minres",
        "minres_restarts"])
def test_indirect_solve_matches_reference(solver, refine_steps, precond):
    """One system, the decomposed banded SDP's reduced KKT: x and nu agree
    to 1e-9 relative and the step count is the reference's, with and
    without the compensated restarts and the overlap preconditioner."""
    xj, nuj, kj = _jax_solve(solver, refine_steps, precond)
    xt, nut, kt, reads = _torch_solve(solver, refine_steps, precond)
    assert kt == kj > 0
    assert np.abs(xt - xj).max() <= 1e-9 * np.abs(xj).max()
    assert np.abs(nut - nuj).max() <= 1e-9 * np.abs(nuj).max()
    # one read before each block, the last one finding the loop done
    sweeps = refine_steps + 1
    assert sweeps <= reads <= kt // tkkt.CG_BLOCK + 2 * sweeps


@pytest.mark.parametrize("solver", ["cg_solve", "minres_solve"])
def test_masked_blocks_stop_where_the_reference_exits(solver):
    """The block-masked loop takes the reference's early exit: every block
    size gives the reference's count and the same iterate bit for bit, and
    a max_iter budget that ends mid-block is honoured exactly."""
    kj = _jax_solve(solver, 1, False)[2]
    runs = [_torch_solve(solver, 1, False, block=blk) for blk in (1, 3, 8, 64)]
    for xt, nut, kt, reads in runs:
        assert kt == kj
        assert np.array_equal(xt, runs[0][0]) and np.array_equal(nut, runs[0][1])
    assert runs[0][3] == kj + 2           # block 1: a read before each step
    xj, _, kj = _jax_solve(solver, 0, False, max_iter=5)
    xt, _, kt, _ = _torch_solve(solver, 0, False, max_iter=5, block=3)
    assert kj == kt == 5
    assert np.abs(xt - xj).max() <= 1e-12 * np.abs(xj).max()


@pytest.mark.parametrize("solver", ["cg", "minres"])
def test_indirect_kkt_matches_dense(solver):
    """tests/test_options.py::test_indirect_kkt_matches_dense: each indirect
    solve against a dense numpy solve of the reduced system (x to 1e-7, nu
    to 1e-6), dense P and A."""
    rng = np.random.default_rng(3)
    n, m = 15, 22
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    A = rng.standard_normal((m, n))
    rho = rng.random(m) + 0.5
    sigma = 1e-6
    r1 = rng.standard_normal(n)
    r2 = rng.standard_normal(m)
    Mred = P + sigma * np.eye(n) + A.T @ (rho[:, None] * A)
    x_ref = np.linalg.solve(Mred, r1 + A.T @ (rho * r2))
    nu_ref = rho * (A @ x_ref - r2)

    fn = tkkt.minres_solve if solver == "minres" else tkkt.cg_solve
    T = torch.as_tensor
    x, nu, k, _ = fn(T(P), T(A), T(sigma), T(rho), T(r1), T(r2), torch.zeros(n,
                     dtype=torch.float64), T(1e-12), T(np.inf), 1000)
    assert np.abs(x.numpy() - x_ref).max() < 1e-7
    assert np.abs(nu.numpy() - nu_ref).max() < 1e-6
    assert 0 < int(k) < 1000


def test_coo_matvec_matches_dense():
    """tests/test_sparse.py::test_coo_matvec_matches_dense on the port's Coo."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((17, 9))
    A[rng.random((17, 9)) < 0.6] = 0.0
    _, coo = _coo_pair(A)
    x = rng.standard_normal(9)
    y = rng.standard_normal(17)
    T = torch.as_tensor
    assert np.allclose(tl.matvec(coo, T(x)).numpy(), A @ x)
    assert np.allclose(tl.rmatvec(coo, T(y)).numpy(), A.T @ y)
    assert np.allclose(tl.colmax_abs(coo).numpy(), np.max(np.abs(A), axis=0))
    assert np.allclose(tl.rowmax_abs(coo).numpy(), np.max(np.abs(A), axis=1))
    rho = rng.random(17) + 0.5
    assert np.allclose(tl.diag_AtRhoA(coo, T(rho)).numpy(),
                       np.diag(A.T @ (rho[:, None] * A)))
    ew = rng.random(17) + 0.5
    dw = rng.random(9) + 0.5
    scaled = tl.scale_rows_cols(coo, T(ew), T(dw))
    assert np.allclose(tl.matvec(scaled, T(x)).numpy(), (ew[:, None] * A * dw[None, :]) @ x)


def _sparse_qp():
    rng = np.random.default_rng(1)
    n, m = 12, 20
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, m


def test_sparse_dense_solve_parity_qp():
    """tests/test_sparse.py::test_sparse_dense_solve_parity_qp: the same QP
    through the dense Cholesky and the sparse CG path agree (objective 1e-4,
    x 1e-4), and the sparse solve matches the reference's CG solve within
    1e-6 in the objective. At this size (12 columns) both packages would
    route the sparse QP to the block KKT; kkt_block_max=8 keeps it on CG."""
    P, q, A, b, m = _sparse_qp()
    s = dict(eps_abs=1e-7, eps_rel=1e-7, kkt_block_max=8)
    r0 = pt.Model(pt.Settings(**s), device="cpu").set(
        P, q, A, b, [pt.Nonnegatives(m)]).optimize()
    m1 = pt.Model(pt.Settings(**s), device="cpu").set(
        sp.csr_matrix(P), q, sp.csr_matrix(A), b, [pt.Nonnegatives(m)])
    r1 = m1.optimize()
    assert r0.status == "Solved" and r1.status == "Solved"
    assert abs(r0.obj_val - r1.obj_val) < 1e-4
    assert np.allclose(r0.x, r1.x, atol=1e-4)
    assert m1.last_solve["kkt_solver"] == "cg" and m1.last_solve["A_layout"] == "Coo"
    assert r1.info.kkt_solver_iters > 0
    mj = ct.Model(ct.Settings(**s)).set(sp.csr_matrix(P), q, sp.csr_matrix(A), b,
                                        [ct.Nonnegatives(m)])
    rj = mj.optimize()
    assert mj._resolved_settings.kkt_solver == "cg"
    assert abs(rj.obj_val - r1.obj_val) <= 1e-6 * abs(rj.obj_val)


def test_sparse_decomposed_sdp():
    """tests/test_sparse.py::test_sparse_decomposed_sdp: sparse maxcut
    through the decomposition (the block KKT takes it in both packages)
    within 1e-3 of the undecomposed dual form, and within 1e-6 of the
    reference."""
    P, q, A, b, sets, L = tprob.maxcut(n_nodes=30, density=0.1, seed=4, sparse=True)
    s = dict(decompose=True, eps_abs=1e-5, eps_rel=1e-5)
    m1 = pt.Model(pt.Settings(**s), device="cpu").set(P, q, A, b, sets)
    r1 = m1.optimize()
    assert m1.last_solve["chordal_blocks"] > 1 and r1.status == "Solved"
    Pd, qd, Ad, bd, setsd = tprob._dual_form_sdp(L, np.float64, sparse=False)
    r0 = pt.Model(pt.Settings(**s), device="cpu").set(Pd, qd, Ad, bd, setsd).optimize()
    assert abs(r1.obj_val - r0.obj_val) / max(1.0, abs(r0.obj_val)) < 1e-3
    rj = ct.Model(ct.Settings(**s)).set(
        *jprob.maxcut(n_nodes=30, density=0.1, seed=4, sparse=True)[:5]).optimize()
    assert abs(rj.obj_val - r1.obj_val) <= 1e-6 * abs(rj.obj_val)


def _qp_box(mod, settings):
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    con = mod.Constraint(A, np.zeros(3), mod.Box([1.0, 0.0, 0.0], [1.0, 0.7, 0.7]))
    kw = {} if mod is ct else dict(device="cpu")
    return mod.Model(**kw).assemble(P, np.array([1.0, 1.0]), [con],
                                    settings=mod.Settings(**settings))


def test_kkt_cg_matches_dense():
    """tests/test_simple_qp.py::test_kkt_cg_matches_dense: the QP with a
    dense A through kkt_solver="cg" at x = [0.3, 0.7] (1e-3), and within
    1e-6 of the reference's CG solve."""
    mt = _qp_box(pt, dict(kkt_solver="cg"))
    rt = mt.optimize()
    rj = _qp_box(ct, dict(kkt_solver="cg")).optimize()
    assert rt.status == rj.status == "Solved"
    assert np.linalg.norm(rt.x - [0.3, 0.7], np.inf) < 1e-3
    assert abs(rt.obj_val - rj.obj_val) <= 1e-6 * abs(rj.obj_val)
    assert mt.last_solve["kkt_solver"] == "cg" and mt.last_solve["A_layout"] == "Tensor"


def _min_eig_sdp(mod):
    rng = np.random.default_rng(0)
    C = rng.standard_normal((6, 6))
    C = (C + C.T) / 2
    d = 21
    svec = (jprob if mod is ct else tprob).svec
    A = np.vstack([svec(np.eye(6)).reshape(1, -1), -np.eye(d)])
    b = np.concatenate([[1.0], np.zeros(d)])
    return (sp.csr_matrix((d, d)), svec(C), sp.csr_matrix(A), b,
            [mod.ZeroSet(1), mod.PsdConeTriangle(d)], np.linalg.eigvalsh(C)[0])


def test_f32_sparse_cg_reaches_tolerance_with_refinement():
    """tests/test_refinement.py::test_f32_reaches_tolerance_with_refinement
    [kkt_solver="cg", sparse=True]: float32 sparse CG with the compensated
    restarts on the rho_eq-conditioned min-eig SDP reaches eps = 1e-5
    (residuals under 10 eps, objective within 1e-3 of lambda_min), as the
    reference does."""
    eps = 1e-5
    *data, lam = _min_eig_sdp(pt)
    mt = pt.Model(pt.Settings(eps_abs=eps, eps_rel=eps, max_iter=20000,
                              dtype=np.float32, kkt_solver="cg"), device="cpu").set(*data)
    rt = mt.optimize()
    assert rt.status == "Solved"
    assert rt.info.r_prim < 10 * eps and rt.info.r_dual < 10 * eps
    assert abs(rt.obj_val - lam) < 1e-3
    info = mt.last_solve
    assert info["kkt_solver"] == "cg" and info["kkt_refine_steps"] == 1
    assert 0 < info["refine_iter"] <= rt.iter
    *jdata, _ = _min_eig_sdp(ct)
    rj = ct.Model(ct.Settings(eps_abs=eps, eps_rel=eps, max_iter=20000,
                              dtype=np.float32, kkt_solver="cg")).set(*jdata).optimize()
    assert rj.status == "Solved" and abs(rj.obj_val - lam) < 1e-3


def test_model_auto_selects_blockdiag_and_matches_cg():
    """tests/test_blockkkt.py::test_model_auto_selects_blockdiag_and_matches_cg:
    the decomposed banded_sdp(60, 5) through the block KKT (auto) and
    through CG with the overlap preconditioner agree within 2e-4; only CG
    reports inner iterations. The CG solve matches the reference's within
    1e-6."""
    gen = (lambda prob: prob.banded_sdp(n_nodes=60, bandwidth=5, seed=3, sparse=True)[:5])
    s = dict(eps_abs=1e-6, eps_rel=1e-6, decompose=True)
    objs = {}
    for ks in ("dense", "cg"):
        mt = pt.Model(pt.Settings(**s, kkt_solver=ks), device="cpu").set(*gen(tprob))
        rt = mt.optimize()
        assert rt.status == "Solved"
        objs[ks] = rt.obj_val
        if ks == "dense":
            assert mt.last_solve["kkt_solver"] == "blockdiag"
            assert rt.info.kkt_solver_iters == 0
        else:
            assert mt.last_solve["kkt_solver"] == "cg"
            assert mt._dev_cache["kkt_precond"] is not None
            assert rt.info.kkt_solver_iters > 0
    assert objs["dense"] == pytest.approx(objs["cg"], abs=2e-4)
    mj = ct.Model(ct.Settings(**s, kkt_solver="cg")).set(*gen(jprob))
    rj = mj.optimize()
    assert rj.status == "Solved"
    assert abs(rj.obj_val - objs["cg"]) <= 1e-6 * abs(rj.obj_val)


def _portfolio_models(k, settings):
    P, q, A, b, sets = tprob.portfolio(k, 1.0, seed=0)
    jsets = [ct.ZeroSet(sets[0].dim), ct.Box(sets[1].l, sets[1].u)]
    mj = ct.Model(ct.Settings(**settings)).set(P, q, A, b, jsets)
    mt = pt.Model(pt.Settings(**settings), device="cpu").set(P, q, A, b, sets)
    return mj, mt


def test_portfolio_resolves_to_cg_and_matches_reference_after_updates():
    """The OSQP benchmarks' portfolio QP at k = 5 factors (n = 500 assets):
    sparse and coupled, so both packages resolve it to CG. A cold solve at
    gamma = 1, then update(q) to gamma = 0.5 and 2 with a warm start from
    the previous solution: every solve Solved and within 1e-6 of the
    reference in the objective. eps is 1e-8: the residual tolerance bounds
    the objective only to about the duality gap, ~5e-7 relative at eps
    1e-7 here."""
    k = 5
    mj, mt = _portfolio_models(k, dict(eps_abs=1e-8, eps_rel=1e-8))
    _, _, mu = tprob.portfolio_data(k, seed=0)
    for gamma in (1.0, 0.5, 2.0):
        if gamma != 1.0:
            for m in (mj, mt):
                m.update(q=tprob.portfolio_q(mu, k, gamma))
        rj, rt = mj.optimize(), mt.optimize()
        assert rj.status == rt.status == "Solved", gamma
        assert mj._resolved_settings.kkt_solver == mt.last_solve["kkt_solver"] == "cg"
        assert abs(rt.obj_val - rj.obj_val) <= 1e-6 * abs(rj.obj_val), gamma
        assert rt.info.kkt_solver_iters > 0
        for m, r in ((mj, rj), (mt, rt)):
            m.warm_start(x0=r.x, y0=r.y, s0=r.s)


def test_portfolio_optimum_matches_reference():
    """problems.portfolio_optimum, the interior-point optimum that
    chip_smoke.py holds the card's k = 200 portfolio solves to, against the
    JAX package's ADMM solve at eps 1e-9 on the k = 5 portfolio at
    gamma = 1 and 2: the objectives within 1e-6 relative (~6e-8 measured),
    the optimum's x in the box and on the budget row to 1e-12."""
    k = 5
    mj, _ = _portfolio_models(k, dict(eps_abs=1e-9, eps_rel=1e-9, max_iter=20000))
    _, _, mu = tprob.portfolio_data(k, seed=0)
    for gamma in (1.0, 2.0):
        mj.update(q=tprob.portfolio_q(mu, k, gamma))
        rj = mj.optimize()
        opt, x = tprob.portfolio_optimum(k, gamma)
        assert rj.status == "Solved", gamma
        assert abs(opt - rj.obj_val) <= 1e-6 * abs(opt), (gamma, opt, rj.obj_val)
        assert x.min() >= 0.0 and x.max() <= 1.0 and abs(x.sum() - 1.0) <= 1e-12
