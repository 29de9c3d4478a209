"""The pow kernel (csrc/exp_pow_proj.cu ``pow_proj_kernel``) emulated on
the host against the plain version, bit for bit.

The kernel's power-cone body (csrc/exp_pow_body.cuh ``project_pow_row``:
the cone test, the polar test, the closed forms, the Newton of case 4) is
compiled here as C++ with g++ (``-ffp-contract=off``: each operation
rounds once, as the ``__d*_rn`` / ``__f*_rn`` intrinsics make it on the
card) and driven as the kernel launches it: blocks of ``kThreads`` threads
(read from the source), thread i of the grid projecting row i, the threads
past the stack doing nothing.

The pow they call is the host's libm ``pow`` / ``powf``, the square root
torch's, by callback (``-DEXP_POW_HOST_SQRT``: torch's CPU square root is
not always correctly rounded, the card's is). The plain version's rows come
from a process whose torch runs its scalar CPU kernels
(``ATEN_CPU_CAPABILITY=default``): there ``torch.pow`` is the same libm
function for every element, where the vectorised one differs from it in
the last bit on ~1.7% of inputs (and then a row's bits would depend on its
place in a batch). Every row must equal the plain version's bits (a NaN
where it has a NaN), float32 and float64, primal and dual, every entry
written exactly once: alpha 0.3, 0.5, 0.8 and mixed in one stack;
``max_iter`` 0, 1, 2 and 20; tol 0 (every Newton runs to ``max_iter``);
NaN and infinite entries; a stack with no case-4 row; N = 1 and N not a
multiple of 32.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cosmo_tpu_torch as pt
from cosmo_tpu_torch import profile_exp as PE

torch.set_num_threads(1)
CSRC = Path(pt.__file__).resolve().parent / "csrc"
ROOT = CSRC.parents[1]
# the pow kernel's block
THREADS = int(re.search(r"constexpr int kThreads = (\d+);",
                        (CSRC / "exp_pow_proj.cu").read_text()).group(1))

HARNESS = r"""
#include <stdint.h>
#include "exp_pow_body.cuh"
using namespace exp_pow;

float (*exp_pow::host_sqrt32)(float);
double (*exp_pow::host_sqrt64)(double);

extern "C" void set_sqrt(float (*f32)(float), double (*f64)(double)) {
  host_sqrt32 = f32;
  host_sqrt64 = f64;
}

// pow_proj_kernel's grid of blocks of `threads`, thread i projecting row i
// (writes[3 i + j]: the stores of out[3 i + j])
template <typename T>
static void run(const T* v, const T* alpha, const uint8_t* dual, const T* tol, T* out,
                int* writes, int n, int max_iter, int threads) {
  const int blocks = (n + threads - 1) / threads;
  for (int block = 0; block < blocks; ++block) {
    for (int thread = 0; thread < threads; ++thread) {
      const int i = block * threads + thread;
      if (i >= n) continue;
      const Vec3<T> x{v[3 * i], v[3 * i + 1], v[3 * i + 2]};
      const Vec3<T> p = project_pow_row(x, alpha[i], dual[i] != 0, tol[i], max_iter);
      out[3 * i] = p.x;
      out[3 * i + 1] = p.y;
      out[3 * i + 2] = p.z;
      for (int j = 0; j < 3; ++j) writes[3 * i + j] += 1;
    }
  }
}

#define ENTRY(T, SFX)                                                                     \
  extern "C" void pow_sched_##SFX(const T* v, const T* a, const uint8_t* d, const T* tol, \
                                  T* out, int* writes, int n, int max_iter, int threads) { \
    run<T>(v, a, d, tol, out, writes, n, max_iter, threads);                               \
  }
ENTRY(float, f32)
ENTRY(double, f64)
"""

# the plain version in a process whose torch takes its scalar CPU kernels
PLAIN = r"""
import sys
import numpy as np
import torch
from cosmo_tpu_torch.ops import exp_pow as E
torch.set_num_threads(1)
cases = np.load(sys.argv[1])
out = {}
for name in cases["names"]:
    V, a, d, t, it = (cases[f"{name}/{k}"] for k in ("V", "alpha", "dual", "tol", "max_iter"))
    stats = {}
    ref = E.project_pow_plain(torch.as_tensor(V), torch.as_tensor(a), torch.as_tensor(d),
                              torch.as_tensor(t), int(it), stats=stats, per_row=True)
    out[f"{name}/out"] = ref.numpy()
    out[f"{name}/row_newton"] = stats["row_newton"].numpy()
    out[f"{name}/newton"] = np.int64(stats.get("newton", 0))
out["capability"] = np.array(torch.backends.cpu.get_cpu_capability())
np.savez(sys.argv[2], **out)
"""

DTYPES = {"f64": np.float64, "f32": np.float32}


def _points(n, seed, dtype, alpha):
    """Gaussian rows at scales e^-3 to e^3 (every 20th with |z| = 1e-9),
    half dual, tolerances 1e-8 and 1e-6; ``alpha`` a number, or "mixed"
    (0.3, 0.5 and 0.8 in one stack)."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-3, 3, (n, 1)))
    V[::20, 2] = 1e-9 * np.sign(V[::20, 2])
    dual = rng.random(n) < 0.5
    tol = np.where(rng.random(n) < 0.5, 1e-8, 1e-6)
    a = rng.choice([0.3, 0.5, 0.8], n) if alpha == "mixed" else np.full(n, alpha)
    return V.astype(dtype), a.astype(dtype), dual, tol.astype(dtype)


def _special_rows(dtype):
    """NaN and infinite entries, as primal rows and negated as dual rows."""
    nan, inf = np.nan, np.inf
    rows = [[nan, 1.0, 1.0], [1.0, nan, 1.0], [1.0, 1.0, nan], [nan, nan, nan],
            [inf, 1.0, 1.0], [-inf, 1.0, 1.0], [1.0, inf, 1.0], [1.0, -inf, 1.0],
            [1.0, 1.0, inf], [1.0, 1.0, -inf], [inf, -inf, inf], [-inf, inf, -inf],
            [0.5, -1.0, nan], [-1.0, -2.0, 3.0], [2.0, -1.0, 0.5], [0.0, 0.0, 1.0]]
    U = np.asarray(rows)
    V = np.concatenate([U, -U]).astype(dtype)
    dual = np.r_[np.zeros(len(U), bool), np.ones(len(U), bool)]
    n = len(V)
    return (V, np.full(n, 0.4, dtype), dual,
            np.where(np.arange(n) % 2 == 0, 1e-8, 1e-6).astype(dtype))


def _no_case4(dtype):
    """Rows in cases 1-3 only: inside the cone, in the polar, |z| below tol."""
    rng = np.random.default_rng(31)
    x, y = rng.uniform(0.5, 2.0, (2, 40))
    inside = np.stack([x, y, 0.1 * x], 1)
    polar = -np.stack([x, y, 0.1 * x], 1)
    flat = np.stack([x - 1.0, -y, np.full(40, 1e-12)], 1)
    V = np.concatenate([inside, polar, flat]).astype(dtype)
    n = len(V)
    return V, np.full(n, 0.5, dtype), np.zeros(n, bool), np.full(n, 1e-8, dtype)


def _cases():
    """Every input the tests hold the emulation to: name -> (V, alpha,
    dual, tol, max_iter)."""
    cases = {}
    for sfx, dtype in DTYPES.items():
        for alpha in (0.3, 0.5, 0.8, "mixed"):
            cases[f"gauss {alpha} {sfx}"] = (*_points(300, 41, dtype, alpha), 20)
        for it in (0, 1, 2):
            cases[f"max_iter {it} {sfx}"] = (*_points(120, 42 + it, dtype, "mixed"), it)
        V, a, d, _ = _points(100, 45, dtype, "mixed")
        cases[f"tol 0 {sfx}"] = (V, a, d, np.zeros(len(V), dtype), 20)
        cases[f"special {sfx}"] = (*_special_rows(dtype), 20)
        cases[f"no case 4 {sfx}"] = (*_no_case4(dtype), 20)
        for n in (1, 33, 95):
            cases[f"n {n} {sfx}"] = (*_points(n, 46 + n, dtype, 0.5), 20)
        cases[f"blocks {sfx}"] = (*_points(3 * THREADS + 17, 47, dtype, 0.5), 20)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The plain version's rows and per-row Newton steps on every case."""
    tmp = tmp_path_factory.mktemp("pow_plain")
    arrays = {"names": np.array(list(CASES))}
    for name, (V, a, d, t, it) in CASES.items():
        arrays.update({f"{name}/V": V, f"{name}/alpha": a, f"{name}/dual": d,
                       f"{name}/tol": t, f"{name}/max_iter": np.int64(it)})
    np.savez(tmp / "cases.npz", **arrays)
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default")
    subprocess.run([sys.executable, "-c", PLAIN, str(tmp / "cases.npz"), str(tmp / "out.npz")],
                   env=env, cwd=ROOT, check=True, timeout=600)
    out = dict(np.load(tmp / "out.npz"))
    assert str(out["capability"]) == "DEFAULT"
    return out


@pytest.fixture(scope="module")
def sched(tmp_path_factory):
    """The harness library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's pow pieces on the host")
    tmp = tmp_path_factory.mktemp("pow_sched")
    src = tmp / "sched.cpp"
    src.write_text(HARNESS)
    so = tmp / "libpow_sched.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared",
                    "-DEXP_POW_HOST_SQRT", f"-I{CSRC}", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib._sqrt = [ctypes.CFUNCTYPE(c, c)(lambda x, dtype=dtype: torch.sqrt(
        torch.tensor([x], dtype=dtype)).item()) for c, dtype in
        ((ctypes.c_float, torch.float32), (ctypes.c_double, torch.float64))]
    lib.set_sqrt(*lib._sqrt)
    return lib


def emulate(lib, V, alpha, dual, tol, max_iter, threads=THREADS):
    """The kernel's rows from the emulation with blocks of ``threads``,
    and the stores of each entry."""
    V = np.ascontiguousarray(V)
    a = np.ascontiguousarray(alpha, dtype=V.dtype)
    d = np.ascontiguousarray(dual, dtype=np.uint8)
    tol = np.ascontiguousarray(tol, dtype=V.dtype)
    out = np.full_like(V, 7.0)
    writes = np.zeros(V.shape, np.int32)
    sfx = "f32" if V.dtype == np.float32 else "f64"
    P, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f"pow_sched_{sfx}")(
        P(V.ctypes.data), P(a.ctypes.data), P(d.ctypes.data), P(tol.ctypes.data),
        P(out.ctypes.data), P(writes.ctypes.data), i(len(V)), i(max_iter), i(threads))
    return out, writes


def same_bits(got, ref):
    """Row-wise: every entry the same bits, or NaN in both."""
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    eq = (got.view(bits) == ref.view(bits)) | (np.isnan(got) & np.isnan(ref))
    return eq.all(axis=1)


def _check(sched, plain, name, threads=THREADS):
    V, a, d, t, it = CASES[name]
    got, writes = emulate(sched, V, a, d, t, it, threads)
    assert (writes == 1).all(), (name, np.argwhere(writes != 1)[:5])
    ref = plain[f"{name}/out"]
    bad = np.nonzero(~same_bits(got, ref))[0]
    assert len(bad) == 0, (name, len(bad), bad[:5], got[bad[:3]], ref[bad[:3]])


@pytest.mark.parametrize("sfx", list(DTYPES))
@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.8, "mixed"], ids=str)
def test_schedule_matches_plain_on_gaussian_rows(sched, plain, alpha, sfx):
    _check(sched, plain, f"gauss {alpha} {sfx}")


@pytest.mark.parametrize("sfx", list(DTYPES))
@pytest.mark.parametrize("max_iter", [0, 1, 2])
def test_schedule_matches_plain_when_max_iter_cuts_the_newton(sched, plain, max_iter, sfx):
    """max_iter 0: no step, phic at |z0| / 2; 1 and 2: rows that have not
    converged take phic anew at their last r."""
    _check(sched, plain, f"max_iter {max_iter} {sfx}")


@pytest.mark.parametrize("sfx", list(DTYPES))
def test_schedule_matches_plain_at_tol_zero(sched, plain, sfx):
    """tol 0: |phi| < 0 never holds, every case-4 row runs 20 steps."""
    name = f"tol 0 {sfx}"
    _check(sched, plain, name)
    assert set(plain[f"{name}/row_newton"].tolist()) == {0, 20}


@pytest.mark.parametrize("sfx", list(DTYPES))
def test_schedule_matches_plain_on_nan_and_inf_rows(sched, plain, sfx):
    _check(sched, plain, f"special {sfx}")


@pytest.mark.parametrize("sfx", list(DTYPES))
def test_schedule_without_case_4_rows(sched, plain, sfx):
    """Every row in cases 1-3: no Newton step."""
    name = f"no case 4 {sfx}"
    assert int(plain[f"{name}/newton"]) == 0
    _check(sched, plain, name)


@pytest.mark.parametrize("sfx", list(DTYPES))
@pytest.mark.parametrize("n", [1, 33, 95])
def test_schedule_at_stack_sizes_off_the_chunk(sched, plain, n, sfx):
    """N = 1 and N not a multiple of 32: the last warp partly past the
    stack; at blocks of 32 and 64 too, each a grid of other blocks."""
    for threads in (THREADS, 32, 64):
        _check(sched, plain, f"n {n} {sfx}", threads)


@pytest.mark.parametrize("sfx", list(DTYPES))
def test_schedule_over_several_blocks(sched, plain, sfx):
    """Three full blocks and part of a fourth: every row written once, at
    the plain version's bits."""
    _check(sched, plain, f"blocks {sfx}")


@pytest.mark.parametrize("sfx", list(DTYPES))
def test_lane_efficiency_counts_the_plain_tally(plain, sfx):
    """profile_exp's lane efficiency of this layout (one thread a row,
    warps of 32 rows in order, each stepping until its slowest lane is
    done) from the plain version's per-row Newton steps: their sum over 32
    times the sum of each warp's most; 1 at tol 0 where every case-4 row
    takes 20 steps and warps are all case 4."""
    for name in (f"blocks {sfx}", f"gauss mixed {sfx}", f"n 33 {sfx}"):
        newton = plain[f"{name}/row_newton"]
        assert newton.sum() == int(plain[f"{name}/newton"])
        warps = np.pad(newton, (0, -len(newton) % 32)).reshape(-1, 32).max(axis=1)
        assert PE.thread_layout_passes(torch.as_tensor(newton)) == warps.sum()
        got = PE.thread_layout_efficiency(torch.as_tensor(newton))
        assert got == PE.lane_efficiency(float(newton.sum()), float(warps.sum()))
        assert got == newton.sum() / (32 * warps.sum()) and 0 < got < 1
    assert PE.thread_layout_efficiency(torch.full((64,), 20)) == 1.0
    assert PE.thread_layout_efficiency(torch.zeros(40, dtype=torch.int64)) == 0.0


def test_per_row_pow_counts_sum_to_the_totals():
    """``per_row`` for the power cone: each row's Newton steps and end
    evaluations, 0 in cases 1-3, summing to the totals kept without it."""
    from cosmo_tpu_torch.ops import exp_pow as E

    V, a, d, t = (torch.as_tensor(x) for x in _points(200, 48, np.float64, "mixed"))
    totals, per_row = {}, {}
    ref = E.project_pow_plain(V, a, d, t, 20, stats=totals)
    got = E.project_pow_plain(V, a, d, t, 20, stats=per_row, per_row=True)
    assert torch.equal(got, ref)
    for key in ("evals", "newton"):
        assert per_row[key] == totals[key] == int(per_row["row_" + key].sum())
    case4 = per_row["row_evals"] > 0
    assert bool((per_row["row_newton"][case4] > 0).all())
    assert not bool(per_row["row_newton"][~case4].any())


def test_recorded_pow_stacks_keep_alpha_and_hand_back_the_count():
    """profile_exp's recorder on the pow wrapper (as ``chip_smoke.py`` 9d
    uses it): every call's rows by reference, alpha, the flags, tolerances
    and loop limit of the call, the launch count handed back."""
    from cosmo_tpu_torch.ops import exp_pow as E
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    V, a, d, t = (torch.as_tensor(x) for x in _points(20, 49, np.float64, "mixed"))
    original, before = K.project_pow, K.project_pow.launches
    try:
        with PE.recorded_stacks("pow") as record:
            assert K.project_pow is not original
            K.project_pow.launches += 3
            outs = [K.project_pow(V + k, a, d, t, 9) for k in range(4)]
        assert K.project_pow is original and original.launches == before + 3
    finally:
        K.project_pow, original.launches = original, before
    assert record["n"] == len(record["V"]) == 4 and record["max_iter"] == 9
    assert record["alpha"] is a and record["is_dual"] is d and record["tol"] is t
    for k, out in enumerate(outs):
        assert torch.equal(PE.recorded_stack(record, k), V + k)
        assert torch.equal(out, E.project_pow_plain(V + k, a, d, t, 9))
    counts = PE.case_mix(V, d, a, t)
    ref_stats = {}
    E.project_pow_plain(V, a, d, t, 9, stats=ref_stats, per_row=True)
    assert sum(counts) == 20 and counts[3] == int((ref_stats["row_evals"] > 0).sum())
