"""The host layer of cosmo_tpu_torch against cosmo_tpu: settings, cones,
constraints and problem generators. Every check compares the two packages
on the same inputs; the host modules are numpy copies, so arrays must be
identical (exact equality)."""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu import settings as jset
from cosmo_tpu.models import cones as jcones
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch import settings as tset
from cosmo_tpu_torch.models import cones as tcones

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_settings_fields_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(ct.Settings)}
    tf = {f.name: f for f in dataclasses.fields(pt.Settings)}
    assert list(jf) == list(tf)
    for name in jf:
        assert _same(jf[name].default, tf[name].default), name


def test_settings_from_dict_and_replace_match():
    d = {"eps_abs": 1e-7, "max_iter": 123, "accelerator": None,
         "eigh_backend": "jacobi", "dtype": "float32"}
    js, ts = ct.Settings.from_dict(d), pt.Settings.from_dict(d)
    assert all(_same(a, b) for a, b in zip(dataclasses.asdict(js).values(),
                                           dataclasses.asdict(ts).values()))
    with pytest.raises(KeyError):
        pt.Settings.from_dict({"no_such_option": 1})
    jr, tr = js.replace(rho=0.5, scaling=3), ts.replace(rho=0.5, scaling=3)
    assert all(_same(a, b) for a, b in zip(dataclasses.asdict(jr).values(),
                                           dataclasses.asdict(tr).values()))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("refine_hint", [False, True])
def test_split_settings_matches(dtype, refine_hint):
    s = dict(accelerator=None, eps_abs=1e-6, adaptive_rho_tolerance=2.0,
             check_infeasibility=30, obj_true=1.5)
    js, jd = jset.split_settings(ct.Settings(**s), 9, 4, dtype, refine_hint=refine_hint)
    ts, td = tset.split_settings(pt.Settings(**s), 9, 4, dtype, refine_hint=refine_hint)
    assert js._fields == ts._fields
    assert tuple(js) == tuple(ts)
    assert jd._fields == td._fields
    for name, jv, tv in zip(jd._fields, jd, td):
        assert isinstance(tv, torch.Tensor) and tv.dim() == 0, name
        assert str(np.asarray(jv).dtype) == str(tv.dtype).replace("torch.", ""), name
        assert np.asarray(jv) == tv.item(), name


CONE_CASES = [
    ("ZeroSet", (3,)), ("Nonnegatives", (4,)), ("SecondOrderCone", (5,)),
    ("PsdCone", (9,)), ("DensePsdCone", (16,)), ("PsdConeTriangle", (6,)),
    ("DensePsdConeTriangle", (10,)), ("PsdConeTriangleColPad", (9,)),
    ("PsdConeTriangleComplex", (4,)), ("ExponentialCone", ()),
    ("DualExponentialCone", ()), ("PowerCone", (0.3,)), ("DualPowerCone", (0.6,)),
]


@pytest.mark.parametrize("name,args", CONE_CASES)
def test_cones_match(name, args):
    jc, tc = getattr(ct, name)(*args), getattr(pt, name)(*args)
    assert jc.dim == tc.dim
    assert getattr(jc, "side", None) == getattr(tc, "side", None)
    assert repr(jc) == repr(tc)
    assert jcones.sort_key(jc) == tcones.sort_key(tc)
    assert jcones.needs_scalar_scaling(jc) == tcones.needs_scalar_scaling(tc)


@pytest.mark.parametrize("name,bad", [
    ("ZeroSet", (-1,)), ("PsdCone", (8,)), ("PsdConeTriangle", (7,)),
    ("SecondOrderCone", (0,)), ("PowerCone", (1.5,)),
])
def test_cone_errors_match(name, bad):
    with pytest.raises(ValueError):
        getattr(ct, name)(*bad)
    with pytest.raises(ValueError):
        getattr(pt, name)(*bad)


def test_box_matches():
    jb, tb = ct.Box([0.0, -1.0], [1.0, 2.0]), pt.Box([0.0, -1.0], [1.0, 2.0])
    assert np.array_equal(jb.l, tb.l) and np.array_equal(jb.u, tb.u)
    assert ct.Box.free(3).dim == pt.Box.free(3).dim == 3
    with pytest.raises(ValueError):
        pt.Box([1.0], [0.0])


def test_constraints_match():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 4))
    b = rng.standard_normal(6)
    for mod in (ct, pt):
        with pytest.raises(ValueError):
            mod.Constraint(A, b[:5], mod.Nonnegatives)
    jc = ct.Constraint(A, b, ct.PsdConeTriangle)
    tc = pt.Constraint(A, b, pt.PsdConeTriangle)
    assert type(jc.convex_set).__name__ == type(tc.convex_set).__name__
    assert np.array_equal(jc.A, tc.A) and np.array_equal(jc.b, tc.b)
    # a type whose row count is not a triangle number: complex Hermitian
    jc = ct.Constraint(rng.standard_normal((4, 3)), np.zeros(4), ct.PsdConeTriangle)
    tc = pt.Constraint(rng.standard_normal((4, 3)), np.zeros(4), pt.PsdConeTriangle)
    assert type(jc.convex_set).__name__ == type(tc.convex_set).__name__ == "PsdConeTriangleComplex"
    # sub-range embedding (constraint.jl:64-70)
    jc = ct.Constraint([[1.0, 2.0]], [3.0], ct.Nonnegatives, dim=5, indices=[1, 3])
    tc = pt.Constraint([[1.0, 2.0]], [3.0], pt.Nonnegatives, dim=5, indices=[1, 3])
    assert sp.issparse(tc.A)
    assert np.array_equal(jc.A.toarray(), tc.A.toarray())
    assert repr(jc) == repr(tc)


def test_block_sdp_and_svec_identical():
    for args in [dict(n_blocks=3, side=4, n=10, seed=1),
                 dict(n_blocks=5, side=8, n=48, seed=0, density=0.2)]:
        jr, tr = jprob.block_sdp(**args), tprob.block_sdp(**args)
        for a, b in zip(jr[:4], tr[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert [s.dim for s in jr[4]] == [s.dim for s in tr[4]]
    S = np.random.default_rng(3).standard_normal((6, 6))
    S = S + S.T
    assert np.array_equal(jprob.svec(S), tprob.svec(S))
    v = tprob.svec(S)
    assert np.array_equal(jprob.smat(v), tprob.smat(v))
    assert np.allclose(tprob.smat(v), S, rtol=0, atol=1e-15)
    assert jprob.tri_dim(7) == tprob.tri_dim(7) == 28


def test_import_pulls_in_neither_jax_nor_cosmo_tpu():
    code = ("import importlib, pkgutil, sys, cosmo_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "cosmo_tpu_torch.__path__, 'cosmo_tpu_torch.')]; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'cosmo_tpu' or m.startswith('cosmo_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
