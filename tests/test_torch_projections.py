"""Cone compilation, projection and the certificates' membership tests of
cosmo_tpu_torch against cosmo_tpu, in float64 on the CPU.

A mixed cone list (Zero, Nonnegatives, Box, SOC, PSD triangles of sides 3,
8 and 16 and a square PSD block) is compiled by the JAX package and carried
across with cosmo_tpu_torch.convert, so both packages project through the
identical compiled structure. Projections are compared to 1e-10 (the PSD
blocks go through independent eigensolvers of LAPACK-level accuracy); the
membership tests must agree exactly."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu.ops import conedata as jcd
from cosmo_tpu.ops import projections as jproj
from cosmo_tpu_torch import convert
from cosmo_tpu_torch.ops import conedata as tcd
from cosmo_tpu_torch.ops import projections as tproj

from _torch_port import as_numpy_dict

torch.set_num_threads(1)
F64 = torch.float64
_jproject = jax.jit(jproj.project)   # one compile per cone structure


def _sets(mod):
    return [
        mod.ZeroSet(3), mod.Nonnegatives(4),
        mod.Box(np.array([-1.0, 0.0, -np.inf]), np.array([1.0, np.inf, 2.0])),
        mod.SecondOrderCone(4), mod.SecondOrderCone(3),
        mod.PsdConeTriangle(6), mod.PsdConeTriangle(36), mod.PsdConeTriangle(136),
        mod.PsdConeTriangle(136), mod.PsdCone(9),
    ]


def _compiled(backend_j="xla", **kw):
    jc = jcd.compile_cones(_sets(ct), dtype=np.float64, eigh_backend=backend_j, **kw)
    return jc, convert.cones_from_dict(as_numpy_dict(jc), "cpu", F64)


def _vectors(m, seed, count=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(m) * s for s in (1.0, 3.0, 0.1, 10.0)][:count]


def test_compile_cones_matches_reference():
    """The port's own compile_cones builds the same arrays as the JAX one."""
    jc = jcd.compile_cones(_sets(ct), dtype=np.float64, eigh_backend="xla")
    tc = tcd.compile_cones(_sets(pt), dtype=np.float64, eigh_backend="xla")
    jd, td = as_numpy_dict(jc), as_numpy_dict(tc)
    for name, tv in td.items():
        if name in ("shard", "own_rows"):
            assert tv is None, name     # the port's mesh fields, unsharded
            continue
        if name in ("soc_buckets", "psd_buckets"):
            assert len(tv) == len(jd[name])
            for jb, tb in zip(jd[name], tv):
                for f, v in tb.items():
                    if f in ("sh_idx", "sym_scale"):
                        continue    # the port's own maps, derived from the others
                    if f == "split":
                        assert v is None    # the mesh field (the reference's spec)
                        continue
                    if isinstance(v, np.ndarray):
                        assert np.array_equal(v, jb[f]), f
                    else:
                        assert v == jb[f], f
        elif isinstance(tv, np.ndarray):
            assert np.array_equal(tv, jd[name]), name
        elif isinstance(tv, dict):      # the exp and pow stacks (empty here)
            assert tv.keys() == jd[name].keys(), name
            for f, v in tv.items():
                assert np.array_equal(v, jd[name][f]), (name, f)
                assert np.asarray(v).dtype == np.asarray(jd[name][f]).dtype, (name, f)
        else:
            assert tv == jd[name], name


@pytest.mark.parametrize("backend_j,backend_t", [("xla", "xla"), ("jacobi", "jacobi"),
                                                 ("jacobi", "pallas")])
def test_project_matches(backend_j, backend_t):
    jc, tc = _compiled(backend_j)
    tc = dataclasses.replace(tc, eigh_backend=backend_t)
    for v in _vectors(jc.m, seed=0):
        js, _ = _jproject(jnp.asarray(v), jc)
        ts, _ = tproj.project(torch.as_tensor(v), tc)
        assert np.abs(np.asarray(js) - ts.numpy()).max() <= 1e-10 * max(1.0, np.abs(v).max())


def test_polar_projection_matches():
    """The Newton-Schulz polar projection (the auto choice for buckets the
    kernel does not take on a card), same schedule in both packages."""
    jc, tc = _compiled("polar")
    for v in _vectors(jc.m, seed=5, count=2):
        js, _ = _jproject(jnp.asarray(v), jc)
        ts, _ = tproj.project(torch.as_tensor(v), tc)
        assert np.abs(np.asarray(js) - ts.numpy()).max() <= 1e-10 * np.abs(v).max()


def _membership_inputs(m):
    """Vectors on both sides of the membership tests: random ones, and
    ones pushed towards K (projected) and towards -K."""
    jc, _ = _compiled("xla")
    out = []
    for v in _vectors(m, seed=2):
        p = np.array(_jproject(jnp.asarray(v), jc)[0])
        out += [v, p, -p, p - v]
    return out


def test_in_pol_recc_multi_matches():
    jc, tc = _compiled("xla")
    tols = (1e-4, 1e-2)
    seen = set()
    for v in _membership_inputs(jc.m):
        jr = jproj.in_pol_recc_multi(jnp.asarray(v), jc, tuple(jnp.asarray(t) for t in tols))
        tr = tproj.in_pol_recc_multi(torch.as_tensor(v), tc,
                                     tuple(torch.tensor(t, dtype=F64) for t in tols))
        assert [bool(x) for x in jr] == [bool(x) for x in tr]
        seen.update(bool(x) for x in tr)
    assert seen == {True, False}


def test_support_function_multi_matches():
    jc, tc = _compiled("xla")
    tols = (1e-4, 1e-2)
    seen_finite = seen_inf = False
    for v in _membership_inputs(jc.m):
        jr = jproj.support_function_multi(jnp.asarray(v), jc, tuple(jnp.asarray(t) for t in tols))
        tr = tproj.support_function_multi(torch.as_tensor(v), tc,
                                          tuple(torch.tensor(t, dtype=F64) for t in tols))
        for a, b in zip(jr, tr):
            a, b = float(a), float(b)
            assert (np.isinf(a) and a == b) or abs(a - b) <= 1e-12 * max(1.0, abs(a))
            seen_finite |= np.isfinite(b)
            seen_inf |= np.isinf(b)
    assert seen_finite and seen_inf


def test_auto_backend_rule():
    """"auto" resolves for the solve's device: eigh on the CPU; on a CUDA
    device the kernel for one bucket of side <= 16 without Anderson, polar
    otherwise (cosmo_tpu.ops.conedata.resolve_eigh_backend)."""
    one = [pt.PsdConeTriangle(136)] * 3
    kw = dict(dtype=np.float64, eigh_backend="auto")
    assert tcd.compile_cones(one, accel_on=False, device="cpu", **kw).eigh_backend == "xla"
    assert tcd.compile_cones(one, accel_on=False, device="cuda", **kw).eigh_backend == "pallas"
    assert tcd.compile_cones(one, accel_on=True, device="cuda", **kw).eigh_backend == "polar"
    big = [pt.PsdConeTriangle(300)]
    assert tcd.compile_cones(big, accel_on=False, device="cuda", **kw).eigh_backend == "polar"
    # several buckets: the dominant small-side bucket with >= 256 blocks
    many = [pt.PsdConeTriangle(36)] * 256 + [pt.PsdConeTriangle(300)]
    tc = tcd.compile_cones(many, accel_on=False, device="cuda", **kw)
    assert tc.eigh_backend == "polar"
    assert [b.backend for b in tc.psd_buckets] == ["pallas", ""]


def test_compile_cones_without_device_resolves_for_cuda():
    """With no device named, "auto" resolves by the CUDA rule: the
    package's entry points solve on the card unless asked for the CPU
    (resolution is host logic, so this runs here)."""
    one = [pt.PsdConeTriangle(136)] * 3
    tc = tcd.compile_cones(one, dtype=np.float64, eigh_backend="auto", accel_on=False)
    assert tc.eigh_backend == "pallas"
    assert tcd.resolve_eigh_backend("auto", tc.psd_buckets, accel_on=False) == "pallas"
    assert tcd.resolve_eigh_backend("auto", tc.psd_buckets, accel_on=False,
                                    device="cpu") == "xla"


def test_split_settings_without_device_targets_cuda():
    """With no device named, the dynamic settings go to ``cuda``, the
    solve's default device, as compile_cones resolves for it: without CUDA
    that fails; ``device="cpu"`` puts them on the CPU."""
    from cosmo_tpu_torch import settings as tset

    if torch.cuda.is_available():
        _, dyn = tset.split_settings(pt.Settings(), 9, 4, np.float32)
        assert all(v.device.type == "cuda" for v in dyn)
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tset.split_settings(pt.Settings(), 9, 4, np.float32)
    _, dyn = tset.split_settings(pt.Settings(), 9, 4, np.float32, device="cpu")
    assert all(v.device.type == "cpu" for v in dyn)


@pytest.mark.parametrize("sets,backend", [
    ([pt.PsdConeTriangle(6)], "amortized"), ([pt.PsdConeTriangle(6)], "jacobi_mm"),
])
def test_unported_cone_features_raise(sets, backend):
    """The backends of these cases raised until the eighth slice ported
    them: both compile as themselves for either device, and a side-3 block
    (padded to 8) projects as the reference projects it, to 1e-10 of the
    largest entry (amortized: the first projection from the identity carry,
    then a second from the carry the first returned)."""
    for device in (None, "cpu"):
        assert tcd.compile_cones(sets, dtype=np.float64, eigh_backend=backend,
                                 device=device).eigh_backend == backend
    sets_j = [ct.PsdConeTriangle(6)]
    jc = jcd.compile_cones(sets_j, dtype=np.float64, eigh_backend=backend)
    tc = tcd.to_device(tcd.compile_cones(sets, dtype=np.float64, eigh_backend=backend,
                                         device="cpu"), "cpu", F64)
    rng = np.random.default_rng(5)
    js = jproj.init_eig_state(jc, jnp.float64)
    ts = tproj.init_eig_state(tc, F64, "cpu")
    assert len(ts) == len(js) == (1 if backend == "amortized" else 0)
    for _ in range(2):
        v = 3.0 * rng.standard_normal(jc.m)
        ref, js = _jproject(jnp.asarray(v), jc, js)
        got, ts = tproj.project(torch.as_tensor(v), tc, ts)
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-10 * np.abs(v).max()
        for a, b in zip(js, ts):
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-10


@pytest.mark.parametrize("cone", [
    lambda mod: mod.ExponentialCone(), lambda mod: mod.PowerCone(0.5),
    lambda mod: mod.PsdConeTriangleComplex(4), lambda mod: mod.DualExponentialCone(),
    lambda mod: mod.DualPowerCone(0.5),
], ids=["exp", "pow", "complex", "dual_exp", "dual_pow"])
def test_formerly_unported_cones_project_as_reference(cone):
    """The cones of test_unported_cone_features_raise that the seventh
    slice ported, beside a nonnegative block: compiled by each package,
    the port's cone data match the reference's, and a random vector (10
    draws, scale 3) projects as the JAX package projects it, to 1e-10 of
    its largest entry (the plain exp/pow version on the CPU; the complex
    block's real embedding through LAPACK eigh in both)."""
    sets_j, sets_t = [ct.Nonnegatives(2), cone(ct)], [pt.Nonnegatives(2), cone(pt)]
    jc = jcd.compile_cones(sets_j, dtype=np.float64, eigh_backend="xla")
    tc = tcd.to_device(tcd.compile_cones(sets_t, dtype=np.float64, eigh_backend="xla",
                                         device="cpu"), "cpu", F64)
    assert (len(jc.psd_buckets), jc.exp.idx.shape[0], jc.pow.idx.shape[0]) == (
        len(tc.psd_buckets), tc.exp.idx.shape[0], tc.pow.idx.shape[0])
    rng = np.random.default_rng(11)
    for _ in range(10):
        v = 3.0 * rng.standard_normal(jc.m)
        ref, _ = _jproject(jnp.asarray(v), jc)
        got, _ = tproj.project(torch.as_tensor(v), tc)
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-10 * np.abs(v).max()
