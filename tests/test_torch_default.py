"""The fourth slice of cosmo_tpu_torch end to end: the default settings —
Anderson acceleration, the f32 refine latch with the df32-compensated KKT
and compensated residuals, the stall toggle — against cosmo_tpu on the CPU.

Solves are compared by status and objective, never by iteration count
(ROADMAP.md "How the port is held"): the decomposed banded SDP in float64
within 1e-6 of JAX and in float32 within 1e-4, and the ports of the
float32 tests of tests/test_refinement.py."""
import numpy as np
import pytest
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch import settings as tset
from cosmo_tpu_torch.ops import kkt as tkkt

torch.set_num_threads(1)

DEFAULT = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000, decompose=True)


def _models(gen, settings):
    mj = ct.Model(ct.Settings(**settings)).set(*gen(jprob))
    mt = pt.Model(pt.Settings(**settings), device="cpu").set(*gen(tprob))
    return mj, mt


def _banded200(prob):
    return prob.banded_sdp(200, 8, seed=0, sparse=True)[:5]


@pytest.mark.parametrize("dtype,obj_tol", [(np.float64, 1e-6), (np.float32, 1e-4)],
                         ids=["float64", "float32"])
def test_default_settings_decomposed_match_reference(dtype, obj_tol):
    """The north-star settings on banded_sdp(200, 8): Solved in both
    packages, objectives within 1e-6 (float64) or 1e-4 (float32). In
    float32 the overlap rows make kkt_refine_steps 1: the latch trips, the
    last history row has it on, and Anderson accelerated."""
    mj, mt = _models(_banded200, dict(DEFAULT, dtype=dtype))
    rj, rt = mj.optimize(), mt.optimize()
    assert rj.status == rt.status == "Solved"
    assert abs(rj.obj_val - rt.obj_val) <= obj_tol * abs(rj.obj_val)
    info = mt.last_solve
    assert info["kkt_solver"] == "blockdiag" and info["accel_mem"] == 15
    assert info["n_accelerated"] > 0
    assert rt.iter >= rt.safeguarding_iter >= 0
    if dtype == np.float32:
        assert info["kkt_refine_steps"] == 1
        assert 0 < info["refine_iter"] <= rt.iter
        assert rt.info.res_history[-1, 5] == 1.0
        assert rt.info.res_history[0, 5] == 0.0
    else:
        assert info["kkt_refine_steps"] == 0 and info["refine_iter"] == -1


def _min_eig_sdp(mod):
    """min tr(CX), tr(X) = 1 over a 6x6 X (rho_eq weighting: kappa(M) ~ 6e3;
    tests/test_refinement.py)."""
    rng = np.random.default_rng(0)
    C = rng.standard_normal((6, 6))
    C = (C + C.T) / 2
    svec = (jprob if mod is ct else tprob).svec
    d = 21
    A = np.vstack([svec(np.eye(6)).reshape(1, -1), -np.eye(d)])
    b = np.concatenate([[1.0], np.zeros(d)])
    return (np.zeros((d, d)), svec(C), A, b, [mod.ZeroSet(1), mod.PsdConeTriangle(d)],
            np.linalg.eigvalsh(C)[0])


def test_f32_reaches_tolerance_with_refinement():
    """tests/test_refinement.py::test_f32_reaches_tolerance_with_refinement
    [dense]: unrefined float32 stalls near 5e-4 on this SDP; with the
    compensated refinement the dense path reaches 1e-6."""
    eps = 1e-6
    *data, lam = _min_eig_sdp(pt)
    mt = pt.Model(pt.Settings(eps_abs=eps, eps_rel=eps, max_iter=20000,
                              dtype=np.float32), device="cpu").set(*data)
    r = mt.optimize()
    assert r.status == "Solved"
    assert r.info.r_prim < 10 * eps and r.info.r_dual < 10 * eps
    assert abs(r.obj_val - lam) < 1e-3
    assert mt.last_solve["kkt_refine_steps"] == 1 and mt.last_solve["refine_iter"] > 0


def test_f32_aa_plain_windows_decomposed_sdp():
    """tests/test_refinement.py::test_f32_aa_plain_windows_decomposed_sdp:
    the restarted memory's plain windows let the f32 default configuration
    reach 1e-5 on the decomposed banded SDP, with the stagnation detector
    set explicitly to 10 (what its auto setting resolves to in float32, so
    the default run is test_default_settings_decomposed_match_reference)."""
    s = dict(eps_abs=1e-5, eps_rel=1e-5, decompose=True, max_iter=6000,
             dtype=np.float32, accelerator_stall_checks=10)
    mt = pt.Model(pt.Settings(**s), device="cpu").set(*_banded200(tprob))
    assert mt.optimize().status == "Solved"
    auto, _ = tset.split_settings(pt.Settings(dtype=np.float32), 4, 4, np.float32,
                                  device="cpu")
    assert auto.accel_stall_checks == 10


def test_loose_eps_converges_without_refined_crawl():
    """tests/test_refinement.py::test_loose_eps_converges_without_refined_
    crawl: at eps looser than kkt_refine_switch, plain convergence trips
    the latch and the next check confirms compensated; the objective is
    held to a tight float64 solve."""
    def gen(prob):
        return prob.banded_sdp(n_nodes=60, bandwidth=5, seed=3, sparse=True)[:5]

    m = pt.Model(pt.Settings(eps_abs=1e-3, eps_rel=1e-3, decompose=True,
                             dtype=np.float32, max_iter=6000), device="cpu").set(*gen(tprob))
    r = m.optimize()
    assert r.status == "Solved"
    assert m.last_solve["refine_iter"] > 0
    m2 = pt.Model(pt.Settings(eps_abs=1e-6, eps_rel=1e-6, decompose=True),
                  device="cpu").set(*gen(tprob))
    r2 = m2.optimize()
    assert abs(r.obj_val - r2.obj_val) < 5e-2 * max(1.0, abs(r2.obj_val))


def test_f32_dense_kkt_inverse_apply_gated_on_accelerator():
    """tests/test_refinement.py::test_f32_dense_kkt_inverse_apply_gated_on_
    accelerator: with Anderson the dense KKT applies by triangular solves
    (the explicit inverse's error floor destabilizes the safeguarded
    accelerator), without it by the inverse; both solve in float32."""
    rng = np.random.default_rng(0)
    k = 8
    C = rng.standard_normal((k, k))
    C = 0.5 * (C + C.T)
    nt = tprob.tri_dim(k)
    A = np.vstack([tprob.svec(np.eye(k))[None, :], -np.eye(nt)])
    b = np.concatenate([[1.0], np.zeros(nt)])
    lam = np.linalg.eigvalsh(C)[0]
    for extra in (dict(max_iter=4000), dict(accelerator=None, max_iter=6000)):
        m = pt.Model(pt.Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float32, **extra),
                     device="cpu")
        r = m.set(np.zeros((nt, nt)), tprob.svec(C), A, b,
                  [pt.ZeroSet(1), pt.PsdConeTriangle(nt)]).optimize()
        assert r.status == "Solved"
        assert abs(r.obj_val - lam) < 1e-3 * abs(lam)
    Af = torch.as_tensor(A, dtype=torch.float32)
    Pf = torch.zeros((nt, nt))
    rho = torch.full((A.shape[0],), 0.1)
    assert tkkt.dense_factor(Pf, Af, 1e-6, rho).Minv is None
    assert tkkt.dense_factor(Pf, Af, 1e-6, rho, use_inverse=True).Minv is not None
