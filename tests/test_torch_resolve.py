"""Re-solves in cosmo_tpu_torch against cosmo_tpu, on the CPU in float64:
``Model.update``, the warm starts, ``assemble(x0, y0, s0)``,
``model_size``, the decomposition and device caches across re-solves, and
the resumable carry (``solver.solve_chunked``). Ports of
tests/test_model_api.py (its time-limit test is in
tests/test_torch_layouts.py) and of the warm-start and update tests of
tests/test_simple_qp.py.

Solves are compared by status and objective (and x where the reference
test compares x) within the stated tolerance; a chunked solve is held to
the uninterrupted one bit for bit."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch import solver as tsolver
from cosmo_tpu_torch.models.model import refine_hint
from cosmo_tpu_torch.ops.scaling import RuizGraph, ruiz_scale
from cosmo_tpu_torch.settings import split_settings

torch.set_num_threads(1)


def _qp(mod):
    """tests/test_model_api.py's random QP with a Nonnegatives cone."""
    rng = np.random.default_rng(0)
    n, m = 8, 12
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, [mod.Nonnegatives(m)]


def _pair(settings, data=_qp):
    """A cosmo_tpu and a cosmo_tpu_torch model of the same problem."""
    mj = ct.Model(ct.Settings(**settings)).set(*data(ct))
    mt = pt.Model(pt.Settings(**settings), device="cpu").set(*data(pt))
    return mj, mt


def _same_obj(rj, rt, tol):
    assert rj.status == rt.status == "Solved"
    assert abs(rj.obj_val - rt.obj_val) <= tol * max(1.0, abs(rj.obj_val))


def test_update_q_b_and_resolve():
    """update(q, b) then optimize equals a fresh model of the updated
    problem (x within 1e-6), and matches the reference's re-solve."""
    s = dict(eps_abs=1e-8, eps_rel=1e-8)
    mj, mt = _pair(s)
    assert mt.optimize().status == "Solved"
    mj.optimize()
    P, q, A, b, sets = _qp(pt)
    q2, b2 = q + 0.1, b + 0.05
    rj, rt = mj.update(q=q2, b=b2).optimize(), mt.update(q=q2, b=b2).optimize()
    _same_obj(rj, rt, 1e-7)
    r3 = pt.Model(pt.Settings(**s), device="cpu").set(P, q2, A, b2, sets).optimize()
    assert np.allclose(rt.x, r3.x, atol=1e-6)


def test_update_dimension_checks():
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        model = mod.Model(**kw).set(*_qp(mod))
        assert model.model_size == (12, 8)
        with pytest.raises(ValueError):
            model.update(q=np.zeros(3))
        with pytest.raises(ValueError):
            model.update(b=np.zeros(3))
        unassembled = mod.Model(**kw)
        assert unassembled.model_size == (0, 0)
        with pytest.raises(RuntimeError):
            unassembled.update(q=np.zeros(8))


def test_warm_start_reduces_iterations():
    """A warm start at the solution takes no more iterations than the cold
    solve, in both packages, and lands on the same objective (1e-7)."""
    s = dict(eps_abs=1e-8, eps_rel=1e-8)
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        r1 = mod.Model(mod.Settings(**s), **kw).set(*_qp(mod)).optimize()
        warm = mod.Model(mod.Settings(**s), **kw).set(*_qp(mod))
        r2 = warm.warm_start(x0=r1.x, y0=r1.y, s0=r1.s).optimize()
        assert r2.status == "Solved"
        assert r2.iter <= r1.iter
        assert abs(r2.obj_val - r1.obj_val) <= 1e-7 * abs(r1.obj_val)


def test_warm_start_partial_indices():
    """Partial warm starts write the given entries; the dual stores
    mu = -y (reference: interface.jl:161-169). The same stored vectors in
    both packages, and a full x0 also sets s0 = b - A x0."""
    models = [ct.Model().set(*_qp(ct)), pt.Model(device="cpu").set(*_qp(pt))]
    for model in models:
        model.warm_start_primal(np.array([1.0, 2.0]), ind=[0, 1])
        model.warm_start_dual(np.array([3.0]), ind=[2])
        model.warm_start_slack(np.array([4.0]), ind=[5])
        assert model.x0[0] == 1.0 and model.x0[1] == 2.0
        assert model.mu0[2] == -3.0 and model.s0[5] == 4.0
    for a in ("x0", "s0", "mu0"):
        assert np.array_equal(getattr(models[0], a), getattr(models[1], a))
    x0 = np.linspace(-1.0, 1.0, 8)
    for model in models:
        model.warm_start_primal(x0)
    _, _, A, b, _ = _qp(pt)
    assert np.array_equal(models[1].s0, b - A @ x0)
    assert np.array_equal(models[0].s0, models[1].s0)


def test_assemble_with_warm_start_arguments():
    """assemble(..., x0, y0, s0) warm starts as warm_start does, in both
    packages, and the warm solve matches the reference (1e-7)."""
    P, q, A, b, _ = _qp(pt)
    r1 = pt.Model(device="cpu").set(*_qp(pt)).optimize()
    out = []
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        con = mod.Constraint(-A, b, mod.Nonnegatives)
        model = mod.Model(mod.Settings(eps_abs=1e-8, eps_rel=1e-8), **kw).assemble(
            P, q, [con], x0=r1.x, y0=r1.y, s0=r1.s)
        assert np.array_equal(model.x0, r1.x) and np.array_equal(model.mu0, -r1.y)
        assert np.array_equal(model.s0, r1.s)
        out.append(model.optimize())
    _same_obj(*out, 1e-7)


def test_empty_model_reuse():
    model = pt.Model(device="cpu").set(*_qp(pt))
    r1 = model.optimize()
    model.empty()
    assert not model.is_assembled and model.x0 is None
    with pytest.raises(RuntimeError):
        model.optimize()
    r2 = model.set(*_qp(pt)).optimize()
    assert abs(r1.obj_val - r2.obj_val) < 1e-8


def test_resolve_moves_only_changed_vectors():
    """The device copies of q/b and of the starting vectors are cached by
    version: a re-solve without changes reuses all of them, update(q)
    replaces q and b only, a warm start only the starting vectors, and the
    structure (cones, operators) survives both."""
    mt = pt.Model(device="cpu").set(*_qp(pt))
    mt.optimize()
    dev = mt._dev_cache
    first = {k: dev[k] for k in ("Pd", "Ad", "cones", "qd", "bd", "x0", "s0", "mu0")}
    mt.optimize()
    assert all(dev[k] is v for k, v in first.items())
    mt.update(q=_qp(pt)[1] * 2.0).optimize()
    assert mt._dev_cache is dev
    assert dev["qd"] is not first["qd"] and dev["bd"] is not first["bd"]
    assert all(dev[k] is first[k] for k in ("Pd", "Ad", "cones", "x0", "s0", "mu0"))
    qd = dev["qd"]
    mt.warm_start(x0=np.ones(8)).optimize()
    assert dev["qd"] is qd and dev["x0"] is not first["x0"]
    assert torch.equal(dev["x0"], torch.ones(8, dtype=torch.float64))


def test_scaling_graph_only_on_cuda():
    """A Model on the CPU keeps no scaling graph, and ruiz_scale handed one
    runs eagerly there: ops/scaling.RuizGraph takes dense CUDA operands
    only (tests/test_torch_cuda.py holds its replays to the eager bits)."""
    mt = pt.Model(device="cpu").set(*_qp(pt))
    mt.optimize()
    assert mt._dev_cache["scale_graph"] is None
    args, dyn, static = _solver_inputs(mt)
    P, A, q, b, cones = args[:5]
    graph = RuizGraph()
    assert not graph.takes(P, A, q)
    eager = ruiz_scale(P, A, q, b, cones, static.scaling_iters, dyn)
    handed = ruiz_scale(P, A, q, b, cones, static.scaling_iters, dyn, graph=graph)
    assert graph.key is None
    flat = lambda out: [*out[:6], *out[6]]  # noqa: E731
    assert all(torch.equal(e, h) for e, h in zip(flat(eager), flat(handed)))


def _solver_inputs(model):
    """The solver's arguments for the problem a model just solved (not
    decomposed), from its device cache and its resolved settings."""
    dev = model._dev_cache
    m, n = model.model_size
    static, dyn = split_settings(model._resolved_settings, m, n, torch.float64,
                                 refine_hint=refine_hint(model.sets), device="cpu")
    args = (dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], dev["cones"],
            dev["x0"], dev["s0"], dev["mu0"])
    return args, dyn, static


@pytest.mark.parametrize("kkt_solver,chunk", [("dense", 25), ("dense", 15), ("cg", 25)],
                         ids=["dense_25", "dense_15", "cg_25"])
def test_chunked_solve_matches_unchunked_trajectory(kkt_solver, chunk):
    """tests/test_model_api.py::test_chunked_solve_matches_unchunked_trajectory
    and ::test_dispatch_chunk_matches_unchunked_trajectory: solve_chunked
    resumes through the full carry, so it lands on the uninterrupted
    trajectory bit for bit — x, iterations and the accumulated inner CG
    steps — with chunks of 25 and 15 iterations (check_termination 5). The
    solve matches the reference's within 1e-8 in the objective."""
    s = dict(eps_abs=1e-9, eps_rel=1e-9, check_termination=5, kkt_solver=kkt_solver)
    mj, mt = _pair(s)
    rt = mt.optimize()
    rj = mj.optimize()
    _same_obj(rj, rt, 1e-8)
    args, dyn, static = _solver_inputs(mt)
    plain = tsolver.solve(*args, dyn, static)
    chunked = tsolver.solve_chunked(*args, dyn, static, chunk=chunk)
    assert chunked["status"] == plain["status"] == 1           # Solved
    assert plain["iter"] > 2 * chunk
    assert chunked["iter"] == plain["iter"] == rt.iter - rt.safeguarding_iter
    assert np.array_equal(chunked["x"], plain["x"]) and np.array_equal(plain["x"], rt.x)
    assert np.array_equal(chunked["y"], plain["y"])
    assert chunked["kkt_solver_iters"] == plain["kkt_solver_iters"]
    assert (plain["kkt_solver_iters"] > 0) == (kkt_solver == "cg")
    assert chunked["projections"] == plain["projections"]


def test_return_carry_resumes_where_it_stopped():
    """solve(return_carry=True) stops at max_iter with the carry and the
    set-up state; solve(carry_in, setup_in) with a larger max_iter goes on
    from there, ignoring x0/s0/mu0, to the uninterrupted result."""
    mt = pt.Model(pt.Settings(eps_abs=1e-9, eps_rel=1e-9), device="cpu").set(*_qp(pt))
    mt.optimize()
    args, dyn, static = _solver_inputs(mt)
    full = tsolver.solve(*args, dyn, static)
    part = tsolver.solve(*args, dyn._replace(max_iter=torch.tensor(20, dtype=torch.int32)),
                         static, return_carry=True)
    assert part["status"] == 2                                        # Max_iter_reached
    assert part["iter"] + part["safeguarding_iter"] == 20
    assert isinstance(part["carry"], tsolver.LoopCarry)
    assert isinstance(part["setup"], tsolver.SetupState)
    junk = (args[:5] + tuple(torch.full_like(a, 7.0) for a in args[5:]))
    rest = tsolver.solve(*junk, dyn, static, carry_in=part["carry"],
                         setup_in=part["setup"])
    assert rest["iter"] == full["iter"] and np.array_equal(rest["x"], full["x"])


def test_nonconvex_P_flagged_unsolved():
    """An indefinite P breaks the Cholesky factor: the solve surfaces
    Unsolved (or a certificate), never Solved, as the reference's does."""
    rng = np.random.default_rng(0)
    n, m = 4, 6
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        res = mod.Model(mod.Settings(max_iter=100), **kw).set(
            -np.eye(n), np.zeros(n), A, b, [mod.Nonnegatives(m)]).optimize()
        assert res.status in ("Unsolved", "Dual_infeasible", "Max_iter_reached")


def test_assemble_with_sparse_constraints():
    """assemble keeps sparse constraint matrices sparse end to end (here
    the block KKT: 10 columns fit kkt_block_max in both packages); the
    sparse solve equals the dense one (x 1e-5) and the reference's (1e-7)."""
    rng = np.random.default_rng(3)
    n, m = 10, 14
    A = sp.random(m, n, density=0.3, random_state=3, format="csr")
    b = np.asarray(A @ rng.standard_normal(n)) + rng.random(m)
    P = sp.identity(n, format="csr")
    q = rng.standard_normal(n)
    s = dict(eps_abs=1e-8, eps_rel=1e-8)
    mt = pt.Model(pt.Settings(**s), device="cpu").assemble(
        P, q, [pt.Constraint(-A, b, pt.Nonnegatives(m))])
    assert sp.issparse(mt.A) and sp.issparse(mt.P)
    r1 = mt.optimize()
    r0 = pt.Model(pt.Settings(**s), device="cpu").assemble(
        P.toarray(), q, [pt.Constraint(-A.toarray(), b, pt.Nonnegatives(m))]).optimize()
    assert r1.status == "Solved"
    assert np.allclose(r1.x, r0.x, atol=1e-5)
    rj = ct.Model(ct.Settings(**s)).assemble(
        P, q, [ct.Constraint(-A, b, ct.Nonnegatives(m))]).optimize()
    _same_obj(rj, r1, 1e-7)


def _banded(n_nodes, bandwidth, seed):
    return lambda mod: (jprob if mod is ct else tprob).banded_sdp(
        n_nodes=n_nodes, bandwidth=bandwidth, seed=seed)[:5]


def test_decomposition_cached_across_solves():
    """The chordal analysis is cached on the model: an update(q) re-solve
    reuses it (no graph time to speak of) and equals a fresh decomposition
    (1e-5) and the reference's re-solve (1e-6)."""
    s = dict(decompose=True, eps_abs=1e-7, eps_rel=1e-7)
    gen = _banded(20, 3, 6)
    mj, mt = _pair(s, gen)
    mt.optimize()
    mj.optimize()
    info1 = mt._chordal_info
    assert info1 is not None and mt.last_solve["chordal_blocks"] > 1
    q = gen(pt)[1]
    r2 = mt.update(q=q * 1.2).optimize()
    assert mt._chordal_info is info1
    assert r2.times.graph_time < 0.05
    P, _, A, b, sets = gen(pt)
    r3 = pt.Model(pt.Settings(**s), device="cpu").set(P, q * 1.2, A, b, sets).optimize()
    assert abs(r2.obj_val - r3.obj_val) < 1e-5
    _same_obj(mj.update(q=q * 1.2).optimize(), r2, 1e-6)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "standard"])
def test_warm_start_composes_with_decomposition(compact):
    """tests/test_model_api.py::test_warm_start_composes_with_decomposition
    and ::..._with_standard_transform: warm starts lift into the decomposed
    space (ChordalInfo.map_warm_start), so a restart from the solution
    takes fewer iterations (compact) or no more (standard), and lands on
    the same objective (1e-5) as the reference's warm solve."""
    s = dict(decompose=True, compact_transformation=compact, eps_abs=1e-7, eps_rel=1e-7)
    gen = _banded(20 if compact else 15, 3, 8)
    mj, mt = _pair(s, gen)
    rj1, r1 = mj.optimize(), mt.optimize()
    assert r1.status == "Solved"
    assert mt._chordal_info.mode == ("compact" if compact else "standard")
    rj2 = mj.warm_start(x0=rj1.x, y0=rj1.y, s0=rj1.s).optimize()
    r2 = mt.warm_start(x0=r1.x, y0=r1.y, s0=r1.s).optimize()
    assert r2.status == "Solved"
    assert r2.iter < r1.iter if compact else r2.iter <= r1.iter
    assert abs(r2.obj_val - r1.obj_val) < 1e-5
    _same_obj(rj2, r2, 1e-5)


def test_update_after_decomposed_solve():
    """Updates stay legal after a decomposed solve: the re-solve equals a
    fresh model of the updated problem (1e-4) and the reference's (1e-6)."""
    s = dict(decompose=True, eps_abs=1e-6, eps_rel=1e-6)
    gen = _banded(15, 3, 4)
    mj, mt = _pair(s, gen)
    assert mt.optimize().status == "Solved"
    mj.optimize()
    q = gen(pt)[1]
    r2 = mt.update(q=q * 1.1).optimize()
    assert r2.status == "Solved"
    P, _, A, b, sets = gen(pt)
    r3 = pt.Model(pt.Settings(**s), device="cpu").set(P, q * 1.1, A, b, sets).optimize()
    assert abs(r2.obj_val - r3.obj_val) < 1e-4
    _same_obj(mj.update(q=q * 1.1).optimize(), r2, 1e-6)


def test_set_dimension_mismatches_raise():
    """set() rejects inconsistent P/q/A/b/cone dimensions
    (reference: interface.jl:35-38)."""
    P, q, A, b = np.eye(2), np.ones(2), np.eye(2), np.zeros(2)
    bad = [
        (P, np.ones(3), A, b, [pt.Nonnegatives(2)]),
        (np.eye(3), q, A, b, [pt.Nonnegatives(2)]),
        (P, q, np.ones((2, 3)), b, [pt.Nonnegatives(2)]),
        (P, q, A, np.zeros(3), [pt.Nonnegatives(2)]),
        (P, q, A, b, [pt.Nonnegatives(1)]),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pt.Model(device="cpu").set(*args)


def test_assemble_scalar_and_vector_P():
    """assemble() takes a scalar, 1x1 or vector P (reference:
    interface.jl:65-88), as the reference does."""
    for P in (np.float64(1.0), np.ones((1, 1)), np.ones(1)):
        m = pt.Model(device="cpu").assemble(
            P, np.ones(1), [pt.Constraint(np.ones((1, 1)), np.zeros(1), pt.ZeroSet)])
        assert m.P.shape == (1, 1) and m.P[0, 0] == 1.0
    m = pt.Model(device="cpu").assemble(
        np.array([2.0, 3.0]), np.ones(2),
        [pt.Constraint(np.eye(2), np.zeros(2), pt.Nonnegatives)])
    np.testing.assert_array_equal(m.P, np.diag([2.0, 3.0]))


def _qp_box(mod):
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    con = mod.Constraint(A, np.zeros(3), mod.Box([1.0, 0.0, 0.0], [1.0, 0.7, 0.7]))
    kw = {} if mod is ct else dict(device="cpu")
    return mod.Model(**kw).assemble(P, np.array([1.0, 1.0]), [con])


def test_qp_warm_start():
    """tests/test_simple_qp.py::test_qp_warm_start: a warm start at the
    solution converges in at most half the iterations, in both packages."""
    for mod in (ct, pt):
        model = _qp_box(mod)
        res1 = model.optimize()
        res2 = model.warm_start(x0=res1.x, y0=res1.y).optimize()
        assert res2.status == "Solved"
        assert res2.iter <= max(res1.iter // 2, 2)


def test_update_b_resolve():
    """tests/test_simple_qp.py::test_update_b_resolve: update(q) raises the
    objective; both packages agree on both solves (1e-4, the default eps
    1e-5 with Anderson)."""
    res = {}
    for mod in (ct, pt):
        model = _qp_box(mod)
        res1 = model.optimize()
        res2 = model.update(q=np.array([2.0, 2.0])).optimize()
        assert res1.status == res2.status == "Solved"
        assert res2.obj_val > res1.obj_val
        res[mod] = (res1, res2)
    for rj, rt in zip(res[ct], res[pt]):
        _same_obj(rj, rt, 1e-4)
