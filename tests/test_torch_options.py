"""Options and entry points of cosmo_tpu_torch against cosmo_tpu, on the
CPU in float64: the auto rho-adaptation interval (the timed probe through
the resumable carry), ``set_csc`` with its SCS-style cone dict,
``verbose_timing``'s phase timers, and the package surface — the names the
port exports, the one-call ``solve`` and the decomposition reports. Ports
of tests/test_options.py."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu.models.model import cone_sets_from_dict as j_cone_sets
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.models.model import cone_sets_from_dict as t_cone_sets

torch.set_num_threads(1)


def _qp(mod):
    """tests/test_options.py's random QP."""
    rng = np.random.default_rng(7)
    n, m = 8, 12
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, [mod.Nonnegatives(m)]


def _probe_qp(mod):
    rng = np.random.default_rng(5)
    n, m = 20, 30
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n) * 3
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, [mod.Nonnegatives(m)]


def test_auto_adaptive_rho_interval():
    """tests/test_options.py::test_auto_adaptive_rho_interval:
    adaptive_rho_interval=0 resolves the interval from a timed probe
    through the carry — a multiple of check_termination, at least one — and
    the solve ends as the reference's does (objective within 1e-7; the
    interval itself depends on the host clock)."""
    s = dict(adaptive_rho_interval=0, eps_abs=1e-8, eps_rel=1e-8, check_termination=10)
    mt = pt.Model(pt.Settings(**s), device="cpu").set(*_probe_qp(pt))
    rt = mt.optimize()
    rj = ct.Model(ct.Settings(**s)).set(*_probe_qp(ct)).optimize()
    assert rt.status == rj.status == "Solved"
    assert abs(rt.obj_val - rj.obj_val) <= 1e-7 * abs(rj.obj_val)
    assert mt.auto_rho_interval is not None          # not solved within the probe
    assert mt.auto_rho_interval % 10 == 0 and mt.auto_rho_interval >= 10
    assert mt.last_solve["auto_rho_interval"] == mt.auto_rho_interval


def test_auto_rho_interval_probe_continues_the_trajectory():
    """The probe's iterations count toward the solve: with
    adaptive_rho_fraction 0 the interval resolves to check_termination, 40
    here, the interval the probe itself runs at, so the probed solve
    follows the trajectory of a solve at interval 40 bit for bit."""
    s = dict(eps_abs=1e-9, eps_rel=1e-9, check_termination=40, adaptive_rho_fraction=0.0,
             accelerator=None)
    probed = pt.Model(pt.Settings(**s, adaptive_rho_interval=0),
                      device="cpu").set(*_probe_qp(pt))
    r1 = probed.optimize()
    assert probed.auto_rho_interval == 40
    plain = pt.Model(pt.Settings(**s, adaptive_rho_interval=40),
                     device="cpu").set(*_probe_qp(pt)).optimize()
    assert r1.status == plain.status == "Solved"
    assert r1.iter == plain.iter > 80 and np.array_equal(r1.x, plain.x)


def test_auto_rho_interval_skips_the_probe_on_short_solves():
    """With max_iter <= 2 check_termination the probe does not run
    (cosmo_tpu.models.model:589-592); the solver's interval 40 applies."""
    mt = pt.Model(pt.Settings(adaptive_rho_interval=0, max_iter=50), device="cpu")
    rt = mt.set(*_qp(pt)).optimize()
    assert mt.auto_rho_interval is None and rt.iter <= 50


def test_set_csc_triangle_dims_convention():
    """set_csc's "s" entries are svec triangle dims, not matrix sides
    (reference: interface.jl:330-336); the same cone list as the
    reference's for every key."""
    sets = t_cone_sets({"f": 1, "s": [6, 10]})
    assert isinstance(sets[1], pt.PsdConeTriangle) and sets[1].side == 3
    assert isinstance(sets[2], pt.PsdConeTriangle) and sets[2].side == 4
    cone = {"f": 2, "l": 3, "q": [3, 4], "s": [6], "ep": 1, "ed": 1, "p": [0.3, -0.6],
            "b": 2}
    lu = (np.zeros(2), np.ones(2))
    tsets, jsets = t_cone_sets(cone, *lu), j_cone_sets(cone, *lu)
    assert [type(s).__name__ for s in tsets] == [type(s).__name__ for s in jsets]
    assert [s.dim for s in tsets] == [s.dim for s in jsets]
    assert [getattr(s, "alpha", None) for s in tsets] == [
        getattr(s, "alpha", None) for s in jsets]


def test_set_csc_end_to_end():
    """tests/test_options.py::test_set_csc_end_to_end: the CSC-triplet entry
    gives set()'s solution (x within 1e-7), as in the reference."""
    P, q, A, b, sets = _qp(pt)
    Pc, Ac = sp.csc_matrix(P), sp.csc_matrix(A)
    triplets = (Pc.data, Pc.indices, Pc.indptr, q, Ac.data, Ac.indices, Ac.indptr, b,
                {"l": A.shape[0]})
    s = dict(eps_abs=1e-8, eps_rel=1e-8)
    r1 = pt.Model(device="cpu").set_csc(*triplets, settings=s).optimize()
    r2 = pt.Model(pt.Settings(**s), device="cpu").set(P, q, A, b, sets).optimize()
    rj = ct.Model().set_csc(*triplets, settings=s).optimize()
    assert r1.status == rj.status == "Solved"
    np.testing.assert_allclose(r1.x, r2.x, atol=1e-7)
    np.testing.assert_allclose(r1.x, rj.x, atol=1e-7)


def test_set_csc_unported_cones_raise():
    """An exponential cone from the cone dict, which raised
    NotImplementedError until the seventh slice, solves through set_csc as
    in the reference: max x s.t. (x, 1, e^2) in K_exp gives x = 2."""
    triplets = (np.zeros(0), np.zeros(0, np.int64), np.zeros(2, np.int64), [-1.0],
                [-1.0], [0], [0, 1], [0.0, 1.0, np.exp(2.0)], {"ep": 1})
    rt = pt.Model(device="cpu").set_csc(*triplets).optimize()
    rj = ct.Model().set_csc(*triplets).optimize()
    assert rt.status == rj.status == "Solved"
    assert abs(rt.x[0] - 2.0) < 1e-3 and abs(rt.x[0] - rj.x[0]) < 1e-6


TIMERS = ("scaling_time", "init_factor_time", "factor_update_time", "proj_time",
          "update_time", "accelerate_time", "setup_time", "graph_time", "iter_time",
          "post_time", "solver_time")


@pytest.mark.parametrize("kkt", ["dense", "cg", "blockdiag"])
def test_verbose_timing_populates_phase_timers(kkt):
    """tests/test_options.py::test_verbose_timing_populates_phase_timers:
    verbose_timing times each phase standalone and scales it by how often
    the solve ran it — every timer finite, projection and update positive,
    the factor timers zero for CG — on the dense, CG and block KKT paths
    (the last a decomposed banded SDP). Before the sixth slice the port left
    all six phase timers NaN."""
    s = dict(verbose_timing=True, eps_abs=1e-6, eps_rel=1e-6)
    if kkt == "blockdiag":
        mt = pt.Model(pt.Settings(**s, decompose=True), device="cpu").set(
            *tprob.banded_sdp(30, 3, seed=0, sparse=True)[:5])
    else:
        mt = pt.Model(pt.Settings(**s, kkt_solver=kkt), device="cpu").set(*_qp(pt))
    t = mt.optimize().times
    assert mt.last_solve["kkt_solver"] == kkt
    for name in TIMERS:
        assert np.isfinite(getattr(t, name)), name
    assert t.proj_time > 0 and t.update_time > 0 and t.scaling_time > 0
    assert t.accelerate_time > 0
    if kkt == "cg":
        assert t.init_factor_time == t.factor_update_time == 0.0
    else:
        assert t.init_factor_time > 0
    if kkt == "dense":
        rj = ct.Model(ct.Settings(**s)).set(*_qp(ct)).optimize()
        for name in TIMERS:
            assert np.isfinite(getattr(rj.times, name)), name


def test_package_exports_match_reference():
    """Every name cosmo_tpu exports exists in cosmo_tpu_torch, but
    enable_x64 (JAX only); the merge strategies are the port's own."""
    missing = set(ct.__all__) - set(pt.__all__)
    assert missing == {"enable_x64"}
    from cosmo_tpu_torch.chordal import merging

    assert pt.MergeStrategy is merging.MergeStrategy
    assert pt.CliqueGraphMerge is merging.CliqueGraphMerge
    assert issubclass(pt.CliqueGraphMerge, pt.MergeStrategy)


@pytest.mark.parametrize("name", ["solve", "print_merge_logs", "print_clique_sizes"])
def test_entry_points_match_reference(name):
    """The three entry points that were stubs raising NotImplementedError
    until the seventh slice: the one-call solve with a cone dict returns
    the reference's result (within 10x eps = 1e-6), and the two
    decomposition reports print the reference's lines after a decomposed
    solve of the banded SDP."""
    import contextlib
    import io

    if name == "solve":
        P, q, A, b, sets = _qp(ct)
        kw = dict(eps_abs=1e-6, eps_rel=1e-6)
        rj = ct.solve(P, q, A, b, {"l": sets[0].dim}, **kw)
        rt = pt.solve(P, q, A, b, {"l": sets[0].dim}, device="cpu", **kw)
        assert rj.status == rt.status == "Solved"
        assert np.abs(rt.x - rj.x).max() <= 1e-5 * max(1.0, np.abs(rj.x).max())
        return
    out = []
    for mod, prob, kw in ((ct, jprob, {}), (pt, tprob, dict(device="cpu"))):
        model = mod.Model(mod.Settings(decompose=True), **kw).set(
            *prob.banded_sdp(30, 3, seed=0, sparse=True)[:5])
        model.optimize()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            getattr(mod, name)(model)
        out.append(buf.getvalue())
    assert out[0] == out[1] and out[1].count("\n") > 2


def test_resolve_methods_exist_and_match_reference():
    """The re-solve surface of the reference's Model, which raised
    AttributeError or TypeError in the port before the sixth slice: update,
    warm_start and its three parts, model_size, set_csc and assemble's
    x0/y0/s0, with the reference's signatures."""
    import inspect

    for name in ("update", "warm_start", "warm_start_primal", "warm_start_dual",
                 "warm_start_slack", "set_csc", "assemble"):
        jp = list(inspect.signature(getattr(ct.Model, name)).parameters)
        tp = list(inspect.signature(getattr(pt.Model, name)).parameters)
        assert tp == jp, name
    assert isinstance(pt.Model.model_size, property)
