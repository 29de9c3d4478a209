"""The first slice of cosmo_tpu_torch end to end: Model.set/assemble ->
Model.optimize against cosmo_tpu, on the CPU, with plain ADMM
(``accelerator=None``) and no chordal decomposition, and the options the
fourth slice ported (Anderson acceleration, the compensated refinement).

Both packages run the same algorithm in float64, so their trajectories
agree to rounding; results are compared within the solve tolerance
(status, objective, x, y and s), never by iteration count (ROADMAP.md "How
the port is held")."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import linops as jl
from cosmo_tpu_torch import problems as tprob

torch.set_num_threads(1)

PLAIN = dict(accelerator=None, decompose=False)
# solutions agree within 10x the solve tolerance eps = 1e-5
TOL = 1e-4


def _solve_both(build, settings, tsettings=None):
    """Run one problem through both packages; ``build(mod)`` sets up a
    model of package ``mod``."""
    mj = build(ct, ct.Model(ct.Settings(**settings)))
    mt = build(pt, pt.Model(pt.Settings(**(tsettings or settings)), device="cpu"))
    return mj, mj.optimize(), mt, mt.optimize()


def _assert_same(rj, rt, tol=TOL):
    assert rj.status == rt.status
    if rj.status == "Solved":
        assert abs(rj.obj_val - rt.obj_val) <= tol * max(1.0, abs(rj.obj_val))
        for a in ("x", "y", "s"):
            ja, ta = getattr(rj, a), getattr(rt, a)
            assert ja.shape == ta.shape
            assert np.abs(ja - ta).max() <= tol * max(1.0, np.abs(ja).max()), a


def _block_sdp(mod, model, n_blocks=12, side=8, n=48):
    P, q, A, b, sets = (jprob if mod is ct else tprob).block_sdp(
        n_blocks=n_blocks, side=side, n=n, seed=0)
    return model.set(P, q, sp.csr_matrix(A), b, sets)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_block_sdp_matches_reference_on_bde_path(dtype):
    """block_sdp with CSR A through the block-dense (Bde) A and the dense
    KKT in both packages. At this size the columns would decouple into the
    block-diagonal KKT; kkt_block_max=1 keeps the problem on the path the
    512-block problem takes. JAX runs the Jacobi of ops/eigh.py, the port
    its kernel's plain version (the same schedule). float32 is held to the
    float64 answer within the 1e-4 f32 regime."""
    s = dict(PLAIN, kkt_block_max=1, dtype=dtype)
    mj, rj, mt, rt = _solve_both(_block_sdp, dict(s, eigh_backend="jacobi"),
                                 dict(s, eigh_backend="pallas"))
    assert isinstance(mj._dev_cache["Ad"], jl.Bde)
    assert mj._resolved_settings.kkt_solver == "dense"
    assert mt.last_solve["A_layout"] == "Bde"
    assert mt.last_solve["bucket_backends"] == ("pallas",)
    assert mt.last_solve["projections"] >= rt.iter
    assert rt.status == "Solved"
    if dtype == np.float64:
        assert mt.last_solve["dtype"] == torch.float64
        _assert_same(rj, rt)
    else:
        assert rt.x.dtype == np.float32
        assert abs(rt.obj_val - rj.obj_val) <= 1e-4 * abs(rj.obj_val)


def test_default_dtype_and_auto_backend_on_cpu():
    mt = _block_sdp(pt, pt.Model(pt.Settings(**PLAIN, kkt_block_max=1), device="cpu"))
    rt = mt.optimize()
    assert rt.status == "Solved"
    assert mt.last_solve["dtype"] == torch.float64
    assert mt.last_solve["eigh_backend"] == "xla"


def _qp(mod, model):
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    con = mod.Constraint(A, np.zeros(3), mod.Box([1.0, 0.0, 0.0], [1.0, 0.7, 0.7]))
    return model.assemble(P, np.array([1.0, 1.0]), [con])


def _lp(mod, model):
    n = 4
    cons = [
        mod.Constraint(-np.eye(n), np.full(n, 10.0), mod.Nonnegatives),
        mod.Constraint(np.eye(n), -np.ones(n), mod.Nonnegatives),
        mod.Constraint([[1.0]], [-5.0], mod.Nonnegatives, n, [1]),
        mod.Constraint([[1.0, 0.0, 1.0, 0.0]], [-4.0], mod.Nonnegatives),
    ]
    return model.assemble(np.zeros((n, n)), np.array([1.0, 2.0, 3.0, 4.0]), cons)


C_MIN_EIG = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]])


def _min_eig(mod, model):
    """min tr(CX) s.t. tr(X) = 1, X PSD, over x = svec(X)."""
    svec = (jprob if mod is ct else tprob).svec
    r = C_MIN_EIG.shape[0]
    d = r * (r + 1) // 2
    tr_row = svec(np.eye(r))[None, :]
    cons = [mod.Constraint(tr_row, [-1.0], mod.ZeroSet),
            mod.Constraint(np.eye(d), np.zeros(d), mod.PsdConeTriangle)]
    return model.assemble(np.zeros((d, d)), svec(C_MIN_EIG), cons)


def _infeasible_lp(mod, model):
    n = 3
    cons = [mod.Constraint(np.eye(n), -np.ones(n), mod.Nonnegatives),   # x >= 1
            mod.Constraint(-np.eye(n), np.zeros(n), mod.Nonnegatives)]  # x <= 0
    return model.assemble(np.zeros((n, n)), np.ones(n), cons)


@pytest.mark.parametrize("build,extra,check", [
    (_qp, {}, lambda r: (np.abs(r.x - [0.3, 0.7]).max() < 1e-3
                         and abs(r.obj_val - 1.88) < 1e-3)),
    (_lp, dict(sparse=False, eps_abs=1e-4),
     lambda r: np.abs(r.x - [3, 5, 1, 1]).max() < 1e-2 and abs(r.obj_val - 20) < 1e-2),
    (_min_eig, {}, lambda r: abs(r.obj_val - np.linalg.eigvalsh(C_MIN_EIG)[0]) < 1e-3),
    (_infeasible_lp, dict(sparse=False), lambda r: r.status == "Primal_infeasible"),
], ids=["qp", "lp", "min_eig", "infeasible_lp"])
def test_known_answers_match_reference(build, extra, check):
    """The four known answers (QP, LP, min-eigenvalue SDP, infeasible
    LP), in both packages (the merged LP constraints are sparse;
    sparse=False takes the dense path both packages share)."""
    _, rj, _, rt = _solve_both(build, dict(PLAIN, **extra))
    assert check(rt), (rt.status, rt.x, rt.obj_val)
    assert rt.status in ("Solved", "Primal_infeasible")
    _assert_same(rj, rt)


def test_non_factorizable_kkt_ends_unsolved():
    """An indefinite P whose KKT matrix has no Cholesky factor: JAX's
    factor is NaN and the solve ends Unsolved; the port must not raise."""
    def build(mod, model):
        con = mod.Constraint(np.array([[1.0, 0.0]]), [0.0], mod.Nonnegatives)
        return model.assemble(-100.0 * np.eye(2), np.ones(2), [con])

    _, rj, _, rt = _solve_both(build, dict(PLAIN, max_iter=50))
    assert rj.status == rt.status == "Unsolved"


def test_model_defaults_to_cuda():
    model = _qp(pt, pt.Model(pt.Settings(**PLAIN)))
    assert model.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            model.optimize()


def _with(**kw):
    return lambda: pt.Settings(**dict(PLAIN, **kw))


@pytest.mark.parametrize("settings,build,tol", [
    (dict(decompose=False), _qp, TOL),                            # Anderson
    (dict(PLAIN, dtype=np.float32), _min_eig, 1e-4),              # auto refine
    (dict(PLAIN, kkt_refine_steps=1), _qp, TOL),
], ids=["anderson", "auto_refine", "refine"])
def test_default_machinery_matches_reference(settings, build, tol):
    """Options that raised before the fourth slice: Anderson acceleration
    (the default accelerator), the auto kkt_refine_steps of a float32
    problem with a ZeroSet row, and an explicit refinement step in float64.
    float32 is held to the reference's objective within its 1e-4 regime."""
    _, rj, mt, rt = _solve_both(build, settings)
    assert rj.status == rt.status == "Solved"
    if settings.get("dtype") == np.float32:
        assert mt.last_solve["kkt_refine_steps"] == 1
        assert abs(rt.obj_val - rj.obj_val) <= tol * max(1.0, abs(rj.obj_val))
    else:
        _assert_same(rj, rt, tol)
    if settings.get("accelerator", "anderson") is not None:
        assert mt.last_solve["n_accelerated"] > 0
        assert rt.safeguarding_iter == rj.safeguarding_iter


@pytest.mark.parametrize("backend", ["amortized", "jacobi_mm"])
def test_unported_options_raise(backend):
    """The last two cases of this test that raised: the eighth slice ported
    the amortized and the jacobi_mm PSD backends. The min-eigenvalue SDP
    (one side-8 bucket: the warm-started Jacobi from the carried basis, or
    the packed-rotation products) solves as the reference does, within 10x
    its eps = 1e-5, and at lambda_min(C)."""
    mj, rj, mt, rt = _solve_both(_min_eig, dict(PLAIN, eigh_backend=backend))
    assert rt.status == "Solved"
    assert mt.last_solve["bucket_backends"] == (backend,)
    assert abs(rt.obj_val - np.linalg.eigvalsh(C_MIN_EIG)[0]) < 1e-3
    _assert_same(rj, rt)


def _dense_kkt_plugin(mod):
    """The dense KKT solve as a user plug-in, in each package's library."""
    if mod is ct:
        import jax.numpy as jnp

        def setup(P, A, sigma, rho):
            return jnp.linalg.inv(P + sigma * jnp.eye(P.shape[0], dtype=P.dtype)
                                  + A.T @ (rho[:, None] * A))

        def solve(Minv, P, A, sigma, rho, r1, r2):
            x = Minv @ (r1 + A.T @ (rho * r2))
            return x, rho * (A @ x - r2)
    else:
        def setup(P, A, sigma, rho):
            return P + sigma * torch.eye(P.shape[0], dtype=P.dtype) + A.T @ (rho[:, None] * A)

        def solve(M, P, A, sigma, rho, r1, r2):
            x = torch.linalg.solve(M, r1 + A.T @ (rho * r2))
            return x, rho * (A @ x - r2)
    return mod.CustomKKTSolver(setup=setup, solve=solve)


@pytest.mark.parametrize("option", ["custom_kkt", "mixed_precision"])
def test_formerly_unported_plugins_match_reference(option):
    """The cases of test_unported_options_raise that the seventh slice
    ported: a custom KKT solver (the dense solve as a plug-in, torch
    callables in the port) and mixed precision (the polar projection's
    loose phase), each on the QP of the verify notes, as the reference
    solves it within 10x its eps = 1e-5."""
    def settings(mod):
        extra = (dict(kkt_solver=_dense_kkt_plugin(mod)) if option == "custom_kkt"
                 else dict(mixed_precision=True, eigh_backend="polar"))
        return mod.Settings(**dict(PLAIN, **extra))

    rj = _qp(ct, ct.Model(settings(ct))).optimize()
    mt = _qp(pt, pt.Model(settings(pt), device="cpu"))
    rt = mt.optimize()
    assert rt.status == "Solved"
    _assert_same(rj, rt)
    if option == "mixed_precision":
        assert mt.last_solve["loose_iter"] > 0


@pytest.mark.parametrize("settings,build,kkt", [
    (dict(PLAIN, kkt_solver="cg"), _qp, "cg"),
    # sparse, coupled beyond kkt_block_max and no Bde layout: Coo + CG
    (dict(PLAIN, kkt_block_max=1), _lp, "cg"),
    (dict(PLAIN, adaptive_rho_interval=0, check_termination=10), _qp, "dense"),
], ids=["cg", "coo", "auto_rho_interval"])
def test_formerly_unported_options_match_reference(settings, build, kkt):
    """The cases of test_unported_options_raise that the sixth slice
    ported: kkt_solver="cg" on a dense problem, sparse coupled input (Coo
    and CG in both packages) and the auto rho-interval probe. Each solves
    as the reference does, within 10x its eps = 1e-5."""
    mj, rj, mt, rt = _solve_both(build, settings)
    _assert_same(rj, rt)
    assert mj._resolved_settings.kkt_solver == mt.last_solve["kkt_solver"] == kkt
    if kkt == "cg":
        assert rt.info.kkt_solver_iters > 0
    if build is _lp:
        assert mt.last_solve["A_layout"] == "Coo"


def test_unported_cones_and_mesh_raise(tmp_path):
    """A one-rank gloo mesh solves the QP bit for bit as the unsharded solve
    does, and a mesh argument that is not a mesh raises TypeError; the
    exponential cone, which raised before the seventh slice, solves as the
    reference does (max x s.t. (x, 1, e^2) in K_exp: x = 2)."""
    import torch.distributed as dist

    from cosmo_tpu_torch.parallel import make_mesh

    def build(mod, model):
        return model.set(np.zeros((1, 1)), [-1.0], [[-1.0], [0.0], [0.0]],
                         [0.0, 1.0, np.exp(2.0)], [mod.ExponentialCone()])

    _, rj, _, rt = _solve_both(build, PLAIN)
    assert rt.status == "Solved" and abs(rt.x[0] - 2.0) < 1e-3
    _assert_same(rj, rt)
    r1 = _qp(pt, pt.Model(pt.Settings(**PLAIN), device="cpu")).optimize()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        model = _qp(pt, pt.Model(pt.Settings(**PLAIN), device="cpu"))
        rm = model.optimize(mesh=make_mesh(1))
        assert model.last_solve["mesh_ranks"] == 1 and model.last_solve["collectives"] > 0
        for a in ("x", "y", "s"):
            np.testing.assert_array_equal(getattr(rm, a), getattr(r1, a))
        assert rm.iter == r1.iter and rm.status == r1.status == "Solved"
        with pytest.raises(TypeError, match="DeviceMesh"):
            model.optimize(mesh=object())
    finally:
        dist.destroy_process_group()
