"""The fifth slice of cosmo_tpu_torch against cosmo_tpu on the CPU in
float64: the shear and colpad layouts of large PSD blocks (projection,
membership tests, the chordal transform's column-padded clique storage,
solves through both) and ``Settings.time_limit``.

The same seeded numpy inputs go through both packages. Projections agree
to rounding (1e-12); plain-ADMM solves to 1e-8 in the objective and 1e-6
in x; default-settings solves (Anderson amplifies rounding) to the solve's
own tolerance."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from _torch_port import as_numpy_dict
from cosmo_tpu import chordal as jch
from cosmo_tpu import problems as jprob
from cosmo_tpu.models import cones as JC
from cosmo_tpu.ops import conedata as jcd
from cosmo_tpu.ops import projections as jpr
from cosmo_tpu_torch import chordal as tch
from cosmo_tpu_torch import convert
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.models import cones as TC
from cosmo_tpu_torch.ops import conedata as tcd
from cosmo_tpu_torch.ops import projections as tpr

torch.set_num_threads(1)

F64 = torch.float64


def tri_dim(r):
    return r * (r + 1) // 2


def _compile_both(make_sets):
    """(JAX ConeData, port ConeData on the CPU) of the cone list that
    ``make_sets(cones module)`` builds."""
    jc = jcd.compile_cones(make_sets(JC), dtype=np.float64)
    tc = tcd.to_device(tcd.compile_cones(make_sets(TC), dtype=np.float64, device="cpu"),
                       "cpu", F64)
    return jc, tc


def _project_both(v, jc, tc):
    sj, _ = jpr.project(jnp_array(v), jc)
    return np.asarray(sj), tpr.project(torch.tensor(v), tc)[0].numpy()


def jnp_array(v):
    import jax.numpy as jnp

    return jnp.asarray(v)


def _index_maps_only(tc):
    """``tc`` with every PSD bucket on the generic index maps."""
    return dataclasses.replace(tc, psd_buckets=tuple(
        dataclasses.replace(b, fastpath="none", contig_start=-1)
        for b in tc.psd_buckets))


def _same_buckets(jc, tc):
    """Every PSD bucket field of the reference's is equal in the port's."""
    for jb, tb in zip(as_numpy_dict(jc)["psd_buckets"], as_numpy_dict(tc)["psd_buckets"]):
        for f, jv in jb.items():
            if f == "spec":
                continue                # the reference's mesh sharding
            tv = tb[f]
            if isinstance(jv, np.ndarray):
                assert np.array_equal(jv, tv), f
            else:
                assert jv == tv, f


def _memberships(v, cones, mod):
    tols = (1e-6, 1e-2)
    x = jnp_array(v) if mod is jpr else torch.tensor(v)
    return ([bool(a) for a in mod.in_pol_recc_multi(x, cones, tols)]
            + [float(a) for a in mod.support_function_multi(x, cones, tols)])


@pytest.mark.parametrize("r", [96, 90])
def test_shear_fast_path_matches_index_maps(r):
    """Three blocks of side r in a k = 96 bucket take the shear layout (r =
    90 pads to 96: r0 < k). The port's projection equals its own index-map
    route and the JAX package's shear route to 1e-12, and the membership
    tests of the infeasibility certificates agree on every layout; the JAX
    package's compiled bucket, carried by convert, projects the same."""
    rng = np.random.default_rng(r)
    jc, tc = _compile_both(lambda M: [M.PsdConeTriangle(tri_dim(r)) for _ in range(3)])
    b = tc.psd_buckets[0]
    assert (b.fastpath, b.side, b.r0) == (jc.psd_buckets[0].fastpath, 96, r) == ("shear", 96, r)
    _same_buckets(jc, tc)
    v = rng.standard_normal(tc.m)
    sj, st = _project_both(v, jc, tc)
    s_maps = tpr.project(torch.tensor(v), _index_maps_only(tc))[0].numpy()
    carried = convert.cones_from_dict(as_numpy_dict(jc), "cpu", F64)
    s_carried = tpr.project(torch.tensor(v), carried)[0].numpy()
    for other in (s_maps, sj, s_carried):
        np.testing.assert_allclose(st, other, rtol=1e-12, atol=1e-12)
    # a positive semidefinite point is inside the cone (margins exactly on
    # it) and a negative one inside the polar: both outcomes of each test
    for w in (v, -np.abs(v), sj):
        got = _memberships(w, tc, tpr)
        assert got == _memberships(w, _index_maps_only(tc), tpr)
        assert got == _memberships(w, jc, jpr)


def _colpad_of(v_tri, r):
    """The column-padded storage of the svec vector of one side-r block."""
    v_cp = np.zeros(r * r)
    for j in range(r):
        for i in range(j + 1):
            v_cp[j * r + i] = v_tri[tri_dim(j) + i]
    return v_cp


def test_colpad_projection_matches_triangle_layout():
    """A colpad block projects to the triangle block's values entry for
    entry with its pad slots exactly 0; both gathers give the same matrix;
    the index-map route (scatter scale 0 on the pad slots) equals the fast
    path; and the port equals the JAX package."""
    rng = np.random.default_rng(3)
    r = 8
    v_tri = rng.standard_normal(tri_dim(r))
    v_cp = _colpad_of(v_tri, r)
    _, tc_t = _compile_both(lambda M: [M.PsdConeTriangle(tri_dim(r))])
    jc_c, tc_c = _compile_both(lambda M: [M.PsdConeTriangleColPad(r * r)])
    assert tc_c.psd_buckets[0].fastpath == "colpad"
    _same_buckets(jc_c, tc_c)
    s_t = tpr.project(torch.tensor(v_tri), tc_t)[0].numpy()
    sj, s_c = _project_both(v_cp, jc_c, tc_c)
    pads = [j * r + i for j in range(r) for i in range(j + 1, r)]
    assert np.all(s_c[pads] == 0.0)
    np.testing.assert_allclose(s_c, _colpad_of(s_t, r), atol=1e-12)
    np.testing.assert_allclose(s_c, sj, atol=1e-12)
    np.testing.assert_allclose(
        tpr.project(torch.tensor(v_cp), _index_maps_only(tc_c))[0].numpy(), s_c, atol=1e-12)
    Xt = tpr._psd_gather(tpr._ext(torch.tensor(v_tri)), tc_t.psd_buckets[0])
    Xc = tpr._psd_gather(tpr._ext(torch.tensor(v_cp)), tc_c.psd_buckets[0])
    np.testing.assert_allclose(Xt.numpy(), Xc.numpy(), atol=1e-12)
    for w in (v_cp, sj, -sj):
        assert _memberships(w, tc_c, tpr) == _memberships(w, jc_c, jpr)


def test_colpad_blocks_survive_small_bucket_consolidation():
    """More than six small sides trigger the small-bucket consolidation;
    colpad blocks stay out of it (merged into a larger side, their maps
    would read and write past their r*r rows into the next cone's). Every
    cone of the mixed list projects as it does alone, and as in the JAX
    package."""
    rng = np.random.default_rng(11)

    def make(M):
        return ([M.PsdConeTriangleColPad(r * r) for r in (9, 10, 11, 12, 13)]
                + [M.PsdConeTriangle(tri_dim(r)) for r in (8, 6, 5, 4, 3, 2, 1)])

    jc, tc = _compile_both(make)
    _same_buckets(jc, tc)
    v = rng.standard_normal(tc.m)
    sj, s_all = _project_both(v, jc, tc)
    np.testing.assert_allclose(s_all, sj, atol=1e-12)
    off = 0
    for cone in make(TC):
        one = tcd.to_device(tcd.compile_cones([type(cone)(cone.dim)], dtype=np.float64,
                                              device="cpu"), "cpu", F64)
        s_one = tpr.project(torch.tensor(v[off:off + cone.dim]), one)[0].numpy()
        np.testing.assert_allclose(s_all[off:off + cone.dim], s_one, atol=1e-12,
                                   err_msg=f"cone at offset {off}")
        off += cone.dim


def _solve_both(gen, **settings):
    mj = ct.Model(ct.Settings(**settings)).set(*gen(jprob))
    mt = pt.Model(pt.Settings(**settings), device="cpu").set(*gen(tprob))
    return mj, mj.optimize(), mt, mt.optimize()


def _assert_plain_parity(rj, rt):
    assert rj.status == rt.status == "Solved"
    assert abs(rt.obj_val - rj.obj_val) <= 1e-8 * abs(rj.obj_val)
    assert np.abs(rt.x - rj.x).max() <= 1e-6 * max(1.0, np.abs(rj.x).max())


def test_closest_correlation_through_the_shear_layout():
    """closest_correlation(72): one block of side 72 in a k = 96 bucket,
    the shear layout with r0 < k, solved with plain ADMM by both
    packages."""
    mj, rj, mt, rt = _solve_both(lambda prob: prob.closest_correlation(n=72)[:5],
                                 accelerator=None, dtype=np.float64)
    bucket = mt._dev_cache["cones"].psd_buckets[0]
    assert (bucket.fastpath, bucket.r0, bucket.side) == ("shear", 72, 96)
    _assert_plain_parity(rj, rt)


def _maxcut25(prob):
    return prob.maxcut(25, 0.15, seed=7)[:5]


COLPAD = dict(decompose=True, colpad_min=8, dtype=np.float64)


def test_colpad_decomposition_matches_reference():
    """With colpad_min = 8 every padded clique block takes colpad storage:
    the port's decomposition gives the JAX package's cone list, A and b
    exactly, and the same row maps."""
    jinfo = jch.decompose(*_maxcut25(jprob), ct.Settings(**COLPAD))
    tinfo = tch.decompose(*_maxcut25(tprob), pt.Settings(**COLPAD))
    jsets, tsets = jinfo.problem[4], tinfo.problem[4]
    assert [(type(s).__name__, s.dim) for s in jsets] == [
        (type(s).__name__, s.dim) for s in tsets]
    assert any(isinstance(s, TC.PsdConeTriangleColPad) for s in tsets)
    A_j, A_t = sp.csr_matrix(jinfo.problem[2]), sp.csr_matrix(tinfo.problem[2])
    assert (A_j != A_t).nnz == 0 and A_j.shape == A_t.shape
    assert np.array_equal(jinfo.problem[3], tinfo.problem[3])
    for f in ("row_map", "ov_child_rows", "ov_parent_rows"):
        assert np.array_equal(getattr(jinfo, f), getattr(tinfo, f)), f


def test_colpad_solve_matches_reference_plain():
    """maxcut(25, 0.15, seed=7) decomposed with every clique block on
    colpad storage, plain ADMM: the port holds the JAX package's objective
    to 1e-8 and x to 1e-6; the reassembled primal block is PSD."""
    mj, rj, mt, rt = _solve_both(_maxcut25, accelerator=None, **COLPAD)
    assert {b.fastpath for b in mt._dev_cache["cones"].psd_buckets} == {"colpad"}
    assert mt.last_solve["chordal_blocks"] == sum(
        isinstance(c, TC.PsdConeTriangleColPad) for c in mt._chordal_info.problem[4]) > 1
    _assert_plain_parity(rj, rt)
    assert np.linalg.eigvalsh(tprob.smat(rt.s)).min() > -1e-7


def test_colpad_solve_matches_reference_default():
    """The same problem at default settings (Anderson acceleration, the
    certificates): both Solved, objectives within 1e-5 relative."""
    mj, rj, mt, rt = _solve_both(_maxcut25, **COLPAD)
    assert rj.status == rt.status == "Solved"
    assert mt.last_solve["n_accelerated"] > 0
    assert abs(rt.obj_val - rj.obj_val) <= 1e-5 * abs(rj.obj_val)


def test_time_limit_status():
    """A tiny budget on a slow problem ends Time_limit_reached (or Solved)
    in both packages; the port keeps the iterate of its last check."""
    def gen(prob):
        return prob.banded_sdp(n_nodes=25, bandwidth=4, seed=2)[:5]

    _, rj, mt, rt = _solve_both(gen, time_limit=1e-4, eps_abs=1e-12, eps_rel=1e-12,
                                max_iter=100000)
    assert rj.status in ("Time_limit_reached", "Solved")
    assert rt.status in ("Time_limit_reached", "Solved")
    assert rt.iter < 100000 and np.isfinite(rt.x).all() and np.isfinite(rt.obj_val)


def _qp(mod):
    rng = np.random.default_rng(0)
    n, m = 8, 12
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, [mod.Nonnegatives(m)]


def test_unreached_time_limit_keeps_the_trajectory():
    """A budget that is never reached leaves the solve as it is: the same
    iteration count and a bit-identical x as without one, and the JAX
    package's status and objective."""
    s = dict(eps_abs=1e-9, eps_rel=1e-9, check_termination=5)
    plain = pt.Model(pt.Settings(**s), device="cpu").set(*_qp(TC))
    timed = pt.Model(pt.Settings(**s, time_limit=3600.0), device="cpu").set(*_qp(TC))
    r_plain, r_timed = plain.optimize(), timed.optimize()
    assert r_timed.status == r_plain.status == "Solved"
    assert r_timed.iter == r_plain.iter
    assert np.array_equal(r_timed.x, r_plain.x)
    rj = ct.Model(ct.Settings(**s, time_limit=3600.0)).set(*_qp(JC)).optimize()
    assert rj.status == "Solved"
    assert abs(r_timed.obj_val - rj.obj_val) <= 1e-6 * max(1.0, abs(rj.obj_val))


def test_blockdiag_time_limit():
    """The decomposed banded SDP through the block-diagonal KKT with a 600
    s budget solves, as in the JAX package."""
    def gen(prob):
        return prob.banded_sdp(n_nodes=60, bandwidth=5, seed=3, sparse=True)[:5]

    _, rj, mt, rt = _solve_both(gen, eps_abs=1e-6, eps_rel=1e-6, decompose=True,
                                time_limit=600.0, dtype=np.float64)
    assert rj.status == rt.status == "Solved"
    assert mt.last_solve["kkt_solver"] == "blockdiag"
    assert abs(rt.obj_val - rj.obj_val) <= 1e-5 * abs(rj.obj_val)
