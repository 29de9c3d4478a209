"""The entry layers of cosmo_tpu_torch against cosmo_tpu, on the CPU in
float64: the CVXPY adapter (a port of tests/test_cvxpy_adapter.py: the
conic-data path on hand-built CVXPY-canonical data, and the ConicSolver
subclass against a mocked ``scs_conif`` module; cvxpy itself is not
installed), the console output (banner, residual rows, footer, merge logs
and clique sizes) and the residual-history ring (a port of
tests/test_observability.py:35-60).

Results are held to the JAX package's within 10 times the solve's eps;
the printed lines must be the JAX package's but for the banner's name.
"""
import contextlib
import io
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import cvxpy_solver as jcs
from cosmo_tpu import problems as jprob
from cosmo_tpu.utils import printing as jprint
from cosmo_tpu_torch import cvxpy_solver as tcs
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.problems import svec

torch.set_num_threads(1)


def _dims(**kw):
    d = types.SimpleNamespace(zero=0, nonneg=0, soc=[], psd=[], exp=0, p3d=[])
    for k, v in kw.items():
        setattr(d, k, v)
    return d


def _both_data(data, settings=None):
    """solve_conic_data of both packages; settings built in each."""
    sj = None if settings is None else ct.Settings(**settings)
    st = None if settings is None else pt.Settings(**settings)
    return (jcs.solve_conic_data(data, settings=sj),
            tcs.solve_conic_data(data, settings=st, device="cpu"))


def _assert_same(oj, ot, tol):
    assert oj["info"]["status"] == ot["info"]["status"]
    assert oj["info"]["status_val"] == ot["info"]["status_val"]
    if oj["info"]["status"] == "Solved":
        assert abs(oj["info"]["pobj"] - ot["info"]["pobj"]) <= tol * max(
            1.0, abs(oj["info"]["pobj"]))
        for a in ("x", "y", "s"):
            assert np.abs(oj[a] - ot[a]).max() <= tol * max(1.0, np.abs(oj[a]).max()), a


# ---- tests/test_cvxpy_adapter.py ------------------------------------------

def test_solve_conic_data_lp():
    """min c'x s.t. x >= 1."""
    data = dict(A=-sp.identity(2, format="csc"), b=-np.ones(2), c=np.array([1.0, 2.0]),
                dims=_dims(nonneg=2))
    oj, ot = _both_data(data, dict(eps_abs=1e-8, eps_rel=1e-8))
    assert ot["info"]["status_val"] == 1
    np.testing.assert_allclose(ot["x"], [1.0, 1.0], atol=1e-5)
    assert abs(ot["info"]["pobj"] - 3.0) < 1e-5
    _assert_same(oj, ot, 1e-7)


def test_solve_conic_data_socp():
    """min t s.t. ||x|| <= t, x = (3, 4) -> t* = 5."""
    A = sp.csc_matrix(np.vstack([np.array([[0.0, 1, 0], [0, 0, 1]]), -np.eye(3)]))
    data = dict(A=A, b=np.array([3.0, 4.0, 0.0, 0.0, 0.0]), c=np.array([1.0, 0.0, 0.0]),
                dims=_dims(zero=2, soc=[3]))
    oj, ot = _both_data(data, dict(eps_abs=1e-8, eps_rel=1e-8))
    assert ot["info"]["status"] == "Solved" and abs(ot["info"]["pobj"] - 5.0) < 1e-4
    _assert_same(oj, ot, 1e-7)


def test_solve_conic_data_sdp_min_eig():
    rng = np.random.default_rng(0)
    C = rng.standard_normal((4, 4))
    C = (C + C.T) / 2
    A = sp.csc_matrix(np.vstack([svec(np.eye(4)).reshape(1, -1), -np.eye(10)]))
    data = dict(A=A, b=np.concatenate([[1.0], np.zeros(10)]), c=svec(C),
                dims=_dims(zero=1, psd=[4]))
    oj, ot = _both_data(data, dict(eps_abs=1e-7, eps_rel=1e-7))
    assert ot["info"]["status"] == "Solved"
    assert abs(ot["info"]["pobj"] - np.linalg.eigvalsh(C)[0]) < 1e-4
    _assert_same(oj, ot, 1e-6)


def test_solve_conic_data_infeasible_maps_to_scs_code():
    data = dict(A=sp.csc_matrix(np.array([[-1.0], [1.0]])), b=np.array([-1.0, 0.0]),
                c=np.ones(1), dims=_dims(nonneg=2))
    oj, ot = _both_data(data)
    assert ot["info"]["status"] == "Primal_infeasible" and ot["info"]["status_val"] == -2
    _assert_same(oj, ot, 1e-4)


def test_cone_dict_from_dims():
    dims = _dims(zero=2, nonneg=3, soc=[3, 4], psd=[5], exp=2, p3d=[0.3])
    cone = tcs._cone_dict_from_dims(dims)
    assert cone == {"f": 2, "l": 3, "q": [3, 4], "s": [15], "ep": 2, "p": [0.3]}
    assert cone == jcs._cone_dict_from_dims(dims)


@contextlib.contextmanager
def _mocked_cvxpy():
    """A stub ``scs_conif.SCS`` when cvxpy is absent (solve_via_data never
    calls into the base class)."""
    names = ("cvxpy", "cvxpy.reductions", "cvxpy.reductions.solvers",
             "cvxpy.reductions.solvers.conic_solvers",
             "cvxpy.reductions.solvers.conic_solvers.scs_conif")
    created = [n for n in names if n not in sys.modules]
    if created:
        mods = {n: types.ModuleType(n) for n in created}
        if "cvxpy.reductions.solvers.conic_solvers.scs_conif" in mods:
            mods["cvxpy.reductions.solvers.conic_solvers.scs_conif"].SCS = type(
                "_StubSCS", (), {})
        sys.modules.update(mods)
    old = tcs._CosmoTpuSolverFactory._cls
    tcs._CosmoTpuSolverFactory._cls = None
    try:
        yield
    finally:
        tcs._CosmoTpuSolverFactory._cls = old
        for n in created:
            sys.modules.pop(n, None)


def test_solver_class_surface_with_mocked_cvxpy():
    """The ConicSolver subclass: name, import_solver, solve_via_data with
    settings options, the device option and the warm-start cache."""
    with _mocked_cvxpy():
        solver = tcs.CosmoTpuSolver()
        assert solver.name() == "COSMO_TPU_TORCH"
        solver.import_solver()
        data = dict(A=-sp.identity(2, format="csc"), b=-np.ones(2), c=np.array([1.0, 2.0]),
                    dims=_dims(nonneg=2))
        cache = {}
        sol = solver.solve_via_data(data, warm_start=False, verbose=False, solver_opts={
            "eps_abs": 1e-8, "eps_rel": 1e-8, "max_iter": 2000, "device": "cpu"},
            solver_cache=cache)
        assert sol["info"]["status_val"] == 1
        np.testing.assert_allclose(sol["x"], [1.0, 1.0], atol=1e-5)
        assert "COSMO_TPU_TORCH" in cache
        sol2 = solver.solve_via_data(data, warm_start=True, verbose=False, solver_opts={
            "eps_abs": 1e-8, "eps_rel": 1e-8, "device": "cpu"}, solver_cache=cache)
        assert sol2["info"]["status_val"] == 1
        assert sol2["info"]["iter"] <= sol["info"]["iter"]
        sol3 = solver.solve_via_data(data, warm_start=False, verbose=True, solver_opts={
            "cosmo_settings": pt.Settings(eps_abs=1e-6, eps_rel=1e-6, verbose=False),
            "device": "cpu"}, solver_cache=None)
        assert sol3["info"]["status_val"] == 1


def test_cvxpy_adapter_needs_cvxpy_only_at_use():
    """Importing the adapter needs no cvxpy; without it, making the solver
    raises ImportError naming cvxpy (with it, the class builds)."""
    try:
        import cvxpy  # noqa: F401
    except ImportError:
        old = tcs._CosmoTpuSolverFactory._cls
        tcs._CosmoTpuSolverFactory._cls = None
        try:
            with pytest.raises(ImportError, match="cvxpy"):
                tcs.CosmoTpuSolver()
        finally:
            tcs._CosmoTpuSolverFactory._cls = old
    else:
        assert tcs.CosmoTpuSolver().name() == "COSMO_TPU_TORCH"


# ---- the one-call solve and the console output -----------------------------

def _qp_args():
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [-1.0, -1.0], [-1.0, 0], [0, -1.0]])
    b = np.array([1.0, 0.7, 0.7, -1.0, 0.0, 0.0])
    return P, np.array([1.0, 1.0]), A, b, {"l": 6}


def test_solve_matches_reference():
    """The one-call solve with a cone dict: the verify notes' QP (x = (0.3,
    0.7), obj 1.88), keywords or a Settings with overrides."""
    rj = ct.solve(*_qp_args(), eps_abs=1e-8, eps_rel=1e-8)
    rt = pt.solve(*_qp_args(), eps_abs=1e-8, eps_rel=1e-8, device="cpu")
    assert rt.status == rj.status == "Solved"
    np.testing.assert_allclose(rt.x, [0.3, 0.7], atol=1e-6)
    assert abs(rt.obj_val - rj.obj_val) < 1e-7
    rt2 = pt.solve(*_qp_args(), settings=pt.Settings(eps_abs=1e-3), eps_abs=1e-8,
                   eps_rel=1e-8, device="cpu")
    assert abs(rt2.obj_val - rt.obj_val) < 1e-7


def _printed(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def test_verbose_solve_prints_as_reference():
    """A verbose solve prints the banner, a residual row at every
    termination check and the footer. The rows hold the JAX package's
    numbers (its in-loop rows print them in full, the port's in the
    four-digit format of ``print_history_rows``); every other line but the
    banner's name and device, and the times, is the JAX package's."""
    s = dict(eps_abs=1e-6, eps_rel=1e-6, verbose=True, accelerator=None)
    rj, lj = _printed(lambda: ct.solve(*_qp_args(), **s))
    rt, lt = _printed(lambda: pt.solve(*_qp_args(), device="cpu", **s))
    assert rt.status == rj.status == "Solved"

    def split(lines):
        rows = [[float(v) for v in ln.split("\t")] for ln in lines if ln[:1].isdigit()]
        text = [ln for ln in lines if not ln[:1].isdigit()
                and not ln.startswith(("Runtime", "Problem")) and "cosmo_tpu" not in ln]
        return np.array(rows), text

    (row_t, text_t), (row_j, text_j) = split(lt), split(lj)
    assert text_t == text_j
    assert row_t.shape == row_j.shape and row_t.shape[0] >= 2
    np.testing.assert_array_equal(row_t[:, 0], row_j[:, 0])
    np.testing.assert_allclose(row_t[:, 1:], row_j[:, 1:], rtol=1e-4, atol=1e-12)


def test_result_footer_with_timing_matches_reference():
    """print_result under verbose_timing prints the same seven timers."""
    model = pt.Model(pt.Settings(verbose_timing=True), device="cpu")
    r = model.set(*_qp_args()[:4], [pt.Nonnegatives(6)]).optimize()
    _, lt = _printed(lambda: pt.utils.printing.print_result(model, r))
    _, lj = _printed(lambda: jprint.print_result(model, r))
    assert lt == lj and any("kkt solves" in ln for ln in lt)


def test_merge_logs_and_clique_sizes_print_as_reference():
    """Both decomposition reports after a decomposed solve, and before one."""
    data = jprob.banded_sdp(30, 3, seed=0, sparse=True)[:5]
    mj = ct.Model(ct.Settings(decompose=True)).set(*data)
    mt = pt.Model(pt.Settings(decompose=True), device="cpu").set(
        *tprob.banded_sdp(30, 3, seed=0, sparse=True)[:5])
    for fj, ft in ((ct.print_merge_logs, pt.print_merge_logs),
                   (ct.print_clique_sizes, pt.print_clique_sizes)):
        assert _printed(lambda: ft(mt))[1] == ["No chordal decomposition was performed."]
    mj.optimize()
    mt.optimize()
    for fj, ft in ((ct.print_merge_logs, pt.print_merge_logs),
                   (ct.print_clique_sizes, pt.print_clique_sizes)):
        lj, lt = _printed(lambda: fj(mj))[1], _printed(lambda: ft(mt))[1]
        assert lt == lj and len(lt) > 2


# ---- tests/test_observability.py:35-60 --------------------------------------

def _history_model(mod, **settings):
    P, q, A, b, sets = (jprob if mod is ct else tprob).block_sdp(
        n_blocks=6, side=4, n=12, seed=1)
    kw = {} if mod is ct else dict(device="cpu")
    return mod.Model(mod.Settings(**settings), **kw).set(P, q, A, b, sets)


@pytest.mark.parametrize("ring,check", [(16, 25), (2, 5)], ids=["ring16", "ring2_wraps"])
def test_residual_history_rows_through_model(ring, check):
    """The ring's rows are the termination checks in order (iteration,
    objective, residuals, rho, refine latch); the last row is the final
    check's; a ring shorter than the checks keeps the last ones. The
    port's rows equal the JAX package's within 10 times eps."""
    s = dict(eps_abs=1e-7, eps_rel=1e-7, residual_history=ring, check_termination=check)
    rj = _history_model(ct, **s).optimize()
    rt = _history_model(pt, **s).optimize()
    h = rt.info.res_history
    assert h is not None and h.shape[1] == 6
    assert np.all(np.diff(h[:, 0]) > 0)
    assert np.isclose(h[-1, 2], rt.info.r_prim) and np.isclose(h[-1, 3], rt.info.r_dual)
    if ring == 2:
        assert h.shape[0] == 2
    hj = rj.info.res_history
    assert hj.shape == h.shape
    np.testing.assert_array_equal(hj[:, 0], h[:, 0])
    assert np.abs(hj[:, 1:5] - h[:, 1:5]).max() <= 1e-6 * max(1.0, np.abs(hj[:, 1:5]).max())


def test_residual_history_disabled():
    rt = _history_model(pt, eps_abs=1e-6, eps_rel=1e-6, residual_history=0).optimize()
    assert rt.info.res_history is None
