"""The second slice of cosmo_tpu_torch end to end: Model.set -> optimize
with chordal decomposition and the block-diagonal KKT, against cosmo_tpu,
on the CPU in float64 with plain ADMM (``accelerator=None``), eps 1e-5.

Both packages run the same algorithm in float64, so their trajectories
agree to rounding: status and objective (1e-6 relative) are compared, and
x, y and s within the solve tolerance — never iteration counts."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob

torch.set_num_threads(1)

DECOMPOSED = dict(decompose=True, accelerator=None, dtype=np.float64,
                  eps_abs=1e-5, eps_rel=1e-5)
OBJ_TOL = 1e-6
# x, y, s agree within 10x the solve tolerance
VEC_TOL = 1e-4

PROBLEMS = {
    # sparse input: the decomposed problem takes the block-diagonal KKT
    "banded200_sparse": (lambda prob: prob.banded_sdp(200, 8, seed=0, sparse=True)[:5],
                         "blockdiag"),
    # dense input: the decomposed problem goes to the dense KKT
    "banded60": (lambda prob: prob.banded_sdp(60, 4)[:5], "dense"),
    "maxcut40": (lambda prob: prob.maxcut(40, 0.15)[:5], "dense"),
}


def _models(gen, jsettings, tsettings=None):
    mj = ct.Model(ct.Settings(**jsettings)).set(*gen(jprob))
    mt = pt.Model(pt.Settings(**(tsettings or jsettings)), device="cpu").set(*gen(tprob))
    return mj, mt


def _assert_same(rj, rt, obj_tol=OBJ_TOL):
    assert rj.status == rt.status == "Solved"
    assert abs(rj.obj_val - rt.obj_val) <= obj_tol * abs(rj.obj_val)
    for a in ("x", "y", "s"):
        ja, ta = getattr(rj, a), getattr(rt, a)
        assert ja.shape == ta.shape
        assert np.abs(ja - ta).max() <= VEC_TOL * max(1.0, np.abs(ja).max()), a


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_decomposed_solve_matches_reference(name):
    gen, kkt = PROBLEMS[name]
    mj, mt = _models(gen, DECOMPOSED)
    rj, rt = mj.optimize(), mt.optimize()
    _assert_same(rj, rt)
    assert mj._resolved_settings.kkt_solver == mt.last_solve["kkt_solver"] == kkt
    assert mt.last_solve["chordal_blocks"] == sum(
        isinstance(s, ct.PsdConeTriangle) for s in mj._chordal_info.problem[4]) > 1
    assert mt.last_solve["A_layout"] == ("Coo" if kkt == "blockdiag" else "Tensor")
    assert rt.times.graph_time > 0 and rt.times.post_time > 0


def test_block_kkt_path_through_the_serial_plain_version():
    """eigh_backend="pallas" on the CPU reaches the plain version of the
    serial Jacobi kernel (tests/test_torch_jacobi_rr.py runs the same case
    through the round-parallel one). Its projection differs from the
    reference's LAPACK one at rounding level, so the stop may fall at
    another check: the objective is held to 1e-5 relative, the solve's
    eps."""
    gen, _ = PROBLEMS["banded200_sparse"]
    mj, mt = _models(gen, DECOMPOSED, dict(DECOMPOSED, eigh_backend="pallas"))
    rj, rt = mj.optimize(), mt.optimize()
    assert rj.status == rt.status == "Solved"
    assert abs(rj.obj_val - rt.obj_val) <= 1e-5 * abs(rj.obj_val)
    assert mt.last_solve["kkt_solver"] == "blockdiag"
    assert mt.last_solve["bucket_backends"] == ("pallas",)
    assert mt.last_solve["jacobi_kernel"] == "jacobi_proj"
    assert mt.last_solve["projections"] >= rt.iter


def test_second_optimize_hits_the_structure_caches():
    """A second optimize() on the same model skips the graph work, the
    block-KKT analysis and the host-to-device copies, and gives the same
    result; set() drops the caches."""
    gen, _ = PROBLEMS["banded200_sparse"]
    mt = pt.Model(pt.Settings(**DECOMPOSED), device="cpu").set(*gen(tprob))
    r1 = mt.optimize()
    info, dev, bk = mt._chordal_info, mt._dev_cache, mt._blockkkt_cache
    r2 = mt.optimize()
    assert mt._chordal_info is info and mt._dev_cache is dev and mt._blockkkt_cache is bk
    assert r2.times.graph_time < 0.1 * r1.times.graph_time
    assert r2.times.setup_time < r1.times.setup_time
    assert r2.status == r1.status and r2.iter == r1.iter
    assert r2.obj_val == r1.obj_val and np.array_equal(r2.x, r1.x)
    mt.set(*gen(tprob))
    assert mt._chordal_info is None and mt._dev_cache is None


def test_min_eig_with_decompose_matches_reference():
    """decompose=True on a dense PSD block: nothing decomposes, and the
    solve is the plain one in both packages."""
    def build(mod):
        C = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]])
        svec = (jprob if mod is ct else tprob).svec
        cons = [mod.Constraint(svec(np.eye(3))[None, :], [-1.0], mod.ZeroSet),
                mod.Constraint(np.eye(6), np.zeros(6), mod.PsdConeTriangle)]
        s = dict(DECOMPOSED)
        return mod.Model(mod.Settings(**s), **({} if mod is ct else {"device": "cpu"})
                         ).assemble(np.zeros((6, 6)), svec(C), cons)

    mj, mt = build(ct), build(pt)
    rj, rt = mj.optimize(), mt.optimize()
    _assert_same(rj, rt)
    assert not mj.is_decomposed and mt.last_solve["chordal_blocks"] == 0
    assert abs(rt.obj_val - np.linalg.eigvalsh(
        [[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]])[0]) < 1e-3


def test_block_sdp_takes_the_block_kkt_and_matches_reference():
    """A sparse problem whose reduced KKT system decouples without any
    decomposition takes the block-diagonal KKT in both packages."""
    def gen(prob):
        P, q, A, b, sets = prob.block_sdp(n_blocks=12, side=8, n=48, seed=0)
        return P, q, sp.csr_matrix(A), b, sets

    s = dict(DECOMPOSED, decompose=False)
    mj, mt = _models(gen, s)
    rj, rt = mj.optimize(), mt.optimize()
    _assert_same(rj, rt)
    assert mj._resolved_settings.kkt_solver == mt.last_solve["kkt_solver"] == "blockdiag"
    assert mt.last_solve["chordal_blocks"] == 0


def test_coupled_sparse_problem_raises_coo_cg():
    """Sparse input that neither decouples within kkt_block_max nor takes
    the block-dense row layout goes through Coo + CG — it raised until the
    sixth slice ported that path, hence the name — in both packages, with
    the same status (a dual-infeasible LP: min 1'x with a coupled
    Nonnegatives constraint and no lower bound on x)."""
    A = sp.csr_matrix(np.random.default_rng(0).normal(size=(30, 20)))

    def gen(mod):
        return (sp.csr_matrix((20, 20)), np.ones(20), A, np.ones(30),
                [mod.Nonnegatives(30)])

    settings = dict(DECOMPOSED, kkt_block_max=8)
    mj = ct.Model(ct.Settings(**settings)).set(*gen(ct))
    mt = pt.Model(pt.Settings(**settings), device="cpu").set(*gen(pt))
    rj, rt = mj.optimize(), mt.optimize()
    assert mj._resolved_settings.kkt_solver == mt.last_solve["kkt_solver"] == "cg"
    assert mt.last_solve["A_layout"] == "Coo"
    assert rt.status == rj.status == "Dual_infeasible"


def test_float32_decomposed_needs_the_df32_endgame():
    """In float32 the overlap rows make the auto kkt_refine_steps 1 (the
    reference's refine_hint): the plain decomposed solve latches into the
    df32 endgame — the refined block KKT and the compensated residuals —
    and solves as the reference does, within the float32 regime of 1e-4."""
    gen, _ = PROBLEMS["banded200_sparse"]
    mj, mt = _models(gen, dict(DECOMPOSED, dtype=np.float32))
    rj, rt = mj.optimize(), mt.optimize()
    assert rj.status == rt.status == "Solved"
    assert abs(rj.obj_val - rt.obj_val) <= 1e-4 * abs(rj.obj_val)
    info = mt.last_solve
    assert info["kkt_solver"] == "blockdiag" and info["kkt_refine_steps"] == 1
    assert 0 < info["refine_iter"] <= rt.iter and rt.info.res_history[-1, 5] == 1.0
