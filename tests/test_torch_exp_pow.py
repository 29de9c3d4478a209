"""The exponential- and power-cone projections of cosmo_tpu_torch against
cosmo_tpu.ops.exp_pow, on the CPU.

The same seeded points (a Gaussian times a scale from e^-3 to e^3 a row,
every 20th with |z| = 1e-9, primal and dual cones mixed, per-row
tolerances of 1e-8 and 1e-6) go through the JAX package's vmapped
while-loops and the port's plain version (batched masked steps). Every row's case (in the cone, in the polar, the
closed form, the bisection or Newton) is checked to occur. Limits, relative
to max |V|: 1e-12 in float64 (the same operations in the same order; the
libraries' log, exp and pow differ in the last bit at most) and 1e-6 in
float32 (measured 1.2e-7 and 3.8e-7; the float32 pow Newton amplifies the
last-bit differences). The membership tests must agree exactly.

The kernel (csrc/exp_pow_proj.cu) runs only on a card, but its per-cone
body (csrc/exp_pow_body.cuh) is plain C++ as well: where g++ is on the
PATH, it is compiled here without FMA contraction and held to the plain
version at the same limits (measured: exp identical, pow 6.6e-16 in
float64; float32 pow as the JAX comparison).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu.ops import conedata as jcd
from cosmo_tpu.ops import exp_pow as J
from cosmo_tpu_torch import convert
from cosmo_tpu_torch.ops import conedata as tcd
from cosmo_tpu_torch.ops import exp_pow as T
from cosmo_tpu_torch.ops import exp_pow_proj

from _torch_port import as_numpy_dict

torch.set_num_threads(1)
LIMIT = {np.float64: 1e-12, np.float32: 1e-6}
CSRC = Path(pt.__file__).resolve().parent / "csrc"


def _points(n, seed, dtype):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-3, 3, (n, 1)))
    # every 20th row has |z| below the tolerance (pow's closed-form case)
    V[::20, 2] = 1e-9 * np.sign(V[::20, 2])
    dual = rng.random(n) < 0.5
    tol = np.where(rng.random(n) < 0.5, 1e-8, 1e-6)
    alpha = rng.choice([0.3, 0.5, 0.8], n)
    return V.astype(dtype), dual, tol.astype(dtype), alpha.astype(dtype)


def _cases(V, dual, tol, alpha=None):
    """Each row's case of _project_exp_one / _project_pow_one (0-3)."""
    U = torch.as_tensor(np.where(dual[:, None], -V, V))
    if alpha is None:
        c1, c2 = T.exp_in_cone(U, 0.0), T.exp_in_dual(-U, 0.0)
        c3 = (U[:, 0] < 0) & (U[:, 1] < 0)
    else:
        a = torch.as_tensor(alpha)
        c1, c2 = T.pow_in_cone(U, a, 0.0), T.pow_in_dual(-U, a, 0.0)
        c3 = U[:, 2].abs() <= torch.as_tensor(tol)
    return np.where(c1, 0, np.where(c2, 1, np.where(c3, 2, 3)))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_exp_projection_matches_reference(dtype):
    V, dual, tol, _ = _points(300, 1, dtype)
    assert set(_cases(V, dual, tol)) == {0, 1, 2, 3}
    ref = np.asarray(J.project_exp(jnp.asarray(V), jnp.asarray(dual), jnp.asarray(tol), 100))
    got = T.project_exp_plain(*_t(V, dual, tol), 100).numpy()
    assert got.dtype == dtype
    assert np.abs(got - ref).max() <= LIMIT[dtype] * np.abs(V).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pow_projection_matches_reference(dtype):
    V, dual, tol, alpha = _points(300, 2, dtype)
    assert set(_cases(V, dual, tol, alpha)) == {0, 1, 2, 3}
    ref = np.asarray(J.project_pow(jnp.asarray(V), jnp.asarray(alpha), jnp.asarray(dual),
                                   jnp.asarray(tol), 20))
    got = T.project_pow_plain(*_t(V, alpha, dual, tol), 20).numpy()
    assert np.abs(got - ref).max() <= LIMIT[dtype] * np.abs(V).max()


def test_short_loops_and_default_tolerance_match_reference():
    """max_iter cuts the bisection (exp) and the Newton (pow) short, lane by
    lane; tol None is 1e-8 in both packages."""
    V, dual, _, alpha = _points(100, 3, np.float64)
    for it in (1, 3):
        ref = np.asarray(J.project_exp(jnp.asarray(V), jnp.asarray(dual), None, it))
        got = T.project_exp_plain(*_t(V, dual), None, it).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(V).max()
        ref = np.asarray(J.project_pow(jnp.asarray(V), jnp.asarray(alpha),
                                       jnp.asarray(dual), None, it))
        got = T.project_pow_plain(*_t(V, alpha, dual), None, it).numpy()
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(V).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("tol", [0.0, 1e-6])
def test_membership_tests_match_reference(dtype, tol):
    V, _, _, alpha = _points(400, 4, dtype)
    for name in ("exp_in_cone", "exp_in_dual"):
        ref = np.asarray(getattr(J, name)(jnp.asarray(V), tol))
        assert (getattr(T, name)(torch.as_tensor(V), tol).numpy() == ref).all(), name
    for name in ("pow_in_cone", "pow_in_dual"):
        ref = np.asarray(getattr(J, name)(jnp.asarray(V), jnp.asarray(alpha), tol))
        got = getattr(T, name)(torch.as_tensor(V), torch.as_tensor(alpha), tol).numpy()
        assert (got == ref).all(), name


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers return the plain version's rows and do
    not count a launch; an empty stack comes back as it is."""
    V, dual, tol, alpha = _points(50, 5, np.float64)
    before = (exp_pow_proj.project_exp.launches, exp_pow_proj.project_pow.launches)
    got = exp_pow_proj.project_exp(*_t(V, dual, tol), 100)
    assert torch.equal(got, T.project_exp_plain(*_t(V, dual, tol), 100))
    got = exp_pow_proj.project_pow(*_t(V, alpha, dual, tol), 20)
    assert torch.equal(got, T.project_pow_plain(*_t(V, alpha, dual, tol), 20))
    empty = torch.zeros((0, 3), dtype=torch.float64)
    assert exp_pow_proj.project_exp(empty, torch.zeros(0, dtype=torch.bool),
                                    torch.zeros(0, dtype=torch.float64)) is empty
    assert (exp_pow_proj.project_exp.launches, exp_pow_proj.project_pow.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        exp_pow_proj.exp_proj_cuda(*_t(V, dual, tol), 100)


def _cones(mod):
    return [mod.Nonnegatives(2), mod.ExponentialCone(), mod.DualExponentialCone(max_iter=50),
            mod.PowerCone(0.3), mod.DualPowerCone(0.7, tol=1e-6, max_iter=30),
            mod.ExponentialCone(tol=1e-6), mod.PsdConeTriangleComplex(9),
            mod.PsdConeTriangleComplex(1), mod.PsdConeTriangle(6)]


def test_compile_cones_matches_reference():
    """The exp and pow stacks (rows, dual flags, tolerances, alpha, the
    largest loop limit), the complex PSD bucket's gather and scatter maps
    and the bounds of a 1x1 Hermitian block are the JAX package's."""
    jc = jcd.compile_cones(_cones(ct), dtype=np.float64, eigh_backend="xla")
    tc = tcd.compile_cones(_cones(pt), dtype=np.float64, eigh_backend="xla", device="cpu")
    for part in ("exp", "pow"):
        jp, tp = getattr(jc, part), getattr(tc, part)
        assert jp.max_iter == tp.max_iter
        for f in ("idx", "is_dual", "tol") + (("alpha",) if part == "pow" else ()):
            np.testing.assert_array_equal(np.asarray(getattr(jp, f)), getattr(tp, f))
    assert len(jc.psd_buckets) == len(tc.psd_buckets)
    for jb, tb in zip(jc.psd_buckets, tc.psd_buckets):
        for f in ("gather_idx", "gather_scale", "scatter_idx", "scatter_scale"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)), getattr(tb, f))
        assert (jb.side, jb.symmetrize, jb.fastpath) == (tb.side, tb.symmetrize, tb.fastpath)
    for f in ("lb", "ub", "nonneg_mask", "rect_mask", "rect_seg"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f))
    assert tc.n_rect_segments == jc.n_rect_segments


def test_converted_cones_project_as_reference():
    """The JAX package's compiled cones carried across with
    convert.cones_from_dict project a random vector as the JAX package
    does (the complex bucket through LAPACK eigh on both sides)."""
    import jax

    from cosmo_tpu.ops import projections as jproj
    from cosmo_tpu_torch.ops import projections as tproj

    jc = jcd.compile_cones(_cones(ct), dtype=np.float64, eigh_backend="xla")
    tc = convert.cones_from_dict(as_numpy_dict(jc), "cpu", torch.float64)
    v = np.random.default_rng(6).standard_normal(jc.m) * 3
    ref, _ = jax.jit(jproj.project)(jnp.asarray(v), jc)
    got = tproj.project(torch.as_tensor(v), tc)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-10 * np.abs(v).max()
    for tol in (0.0, 1e-3):
        y = torch.as_tensor(-np.abs(v))
        assert bool(tproj.in_pol_recc_multi(y, tc, (tol,))[0]) == bool(
            jproj.in_pol_recc(jnp.asarray(-np.abs(v)), jc, tol))
        assert float(tproj.support_function_multi(y, tc, (tol,))[0]) == float(
            jproj.support_function(jnp.asarray(-np.abs(v)), jc, tol))


def _host_body(tmp_path):
    """The kernel's per-cone body compiled as C++ on the host (no FMA
    contraction, so each operation rounds once as on the card), with one C
    entry a family and type looping over the rows."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel body on the host")
    src = tmp_path / "host.cpp"
    src.write_text("""
#include <stdint.h>
#include "exp_pow_body.cuh"
template <typename T>
static void exp_rows(const T* v, const uint8_t* d, const T* tol, T* o, int n, int mi) {
  for (int i = 0; i < n; ++i) {
    exp_pow::Vec3<T> p = exp_pow::project_exp_row(
        exp_pow::Vec3<T>{v[3 * i], v[3 * i + 1], v[3 * i + 2]}, d[i] != 0, tol[i], mi);
    o[3 * i] = p.x; o[3 * i + 1] = p.y; o[3 * i + 2] = p.z;
  }
}
template <typename T>
static void pow_rows(const T* v, const T* a, const uint8_t* d, const T* tol, T* o, int n,
                     int mi) {
  for (int i = 0; i < n; ++i) {
    exp_pow::Vec3<T> p = exp_pow::project_pow_row(
        exp_pow::Vec3<T>{v[3 * i], v[3 * i + 1], v[3 * i + 2]}, a[i], d[i] != 0, tol[i], mi);
    o[3 * i] = p.x; o[3 * i + 1] = p.y; o[3 * i + 2] = p.z;
  }
}
extern "C" {
void exp_f32(const float* v, const uint8_t* d, const float* t, float* o, int n, int mi) {
  exp_rows(v, d, t, o, n, mi); }
void exp_f64(const double* v, const uint8_t* d, const double* t, double* o, int n, int mi) {
  exp_rows(v, d, t, o, n, mi); }
void pow_f32(const float* v, const float* a, const uint8_t* d, const float* t, float* o,
             int n, int mi) { pow_rows(v, a, d, t, o, n, mi); }
void pow_f64(const double* v, const double* a, const uint8_t* d, const double* t, double* o,
             int n, int mi) { pow_rows(v, a, d, t, o, n, mi); }
}
""")
    so = tmp_path / "libexp_pow_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True)
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_body_on_the_host_matches_plain(tmp_path, dtype):
    lib = _host_body(tmp_path)
    V, dual, tol, alpha = _points(2000, 7, dtype)
    V = np.ascontiguousarray(V)
    d = dual.astype(np.uint8)
    sfx = "f32" if dtype == np.float32 else "f64"
    P = ctypes.c_void_p
    out = np.empty_like(V)
    getattr(lib, "exp_" + sfx)(P(V.ctypes.data), P(d.ctypes.data), P(tol.ctypes.data),
                               P(out.ctypes.data), ctypes.c_int(len(V)), ctypes.c_int(100))
    ref = T.project_exp_plain(*_t(V, dual, tol), 100).numpy()
    assert np.abs(out - ref).max() <= LIMIT[dtype] * np.abs(V).max()
    getattr(lib, "pow_" + sfx)(P(V.ctypes.data), P(alpha.ctypes.data), P(d.ctypes.data),
                               P(tol.ctypes.data), P(out.ctypes.data), ctypes.c_int(len(V)),
                               ctypes.c_int(20))
    ref = T.project_pow_plain(*_t(V, alpha, dual, tol), 20).numpy()
    err = np.abs(out - ref).max(axis=1) / np.abs(V).max()
    if dtype == np.float64:
        assert err.max() <= LIMIT[dtype]
    else:
        # float32 pow: where phic's square root cancels, the reference's
        # Newton keeps no digit (its float32 and float64 runs differ by up
        # to 1.4 on such rows), so a last-bit difference in pow moves them:
        # at most 1 row in 1,000 beyond 1e-4
        assert (err > 1e-4).sum() <= max(1, len(V) // 1000) and np.median(err) <= 1e-7
