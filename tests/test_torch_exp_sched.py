"""The exp kernel's schedule (csrc/exp_pow_proj.cu) emulated on the host
against the plain version, bit for bit.

The kernel's step machine (csrc/exp_pow_body.cuh) is compiled here as C++
with g++ (``-ffp-contract=off``: each operation rounds once, as the
``__d*_rn`` / ``__f*_rn`` intrinsics make it on the card) and driven by a
host emulation of the kernel's schedule: warps of 32 lanes in lockstep,
one Newton step a pass, a cone on L lanes evaluating ahead (the bound
search's next doublings, the bisection's next levels of midpoints), rows
taken from a row cursor shared by the warps, as many as a warp's idle
cones lack, classified, rows in cases 1-3 written at once and case-4 rows
queued a warp, idle cones refilled from the queue, and at a block's window
end, once its rows are gone, its live cones moved to its first warps. The log and exp it
calls are the plain version's (torch's, by callback, a batch of lanes a
call), as on the card both take CUDA's. Every row must equal
``project_exp_plain``'s bits (a NaN where it has a NaN), float32 and
float64, primal and dual, on 3 lanes a cone (the kernel's) and on 1 and 7
(the walk at other depths): on Gaussian rows, rows whose bound search
reaches its cap of 90 doublings, ``max_iter`` 1, 2, 3 and 100 (the
look-ahead passes the stop), tol 0 (the bisection runs to ``max_iter``),
NaN and infinite entries, and a row with g(lambda) = 0 exactly at a
midpoint.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import cosmo_tpu_torch as pt
from cosmo_tpu_torch import profile_exp as PE
from cosmo_tpu_torch.ops import exp_pow as T

torch.set_num_threads(1)
CSRC = Path(pt.__file__).resolve().parent / "csrc"
# lanes a cone: the kernel's kLanes (3), and 1 and 7, the walk at other
# depths
LANES = [3, 1, 7]

HARNESS = r"""
#include <stdint.h>
#include <algorithm>
#include <vector>
#include "exp_pow_body.cuh"
using namespace exp_pow;

// x[i] = f(x[i]) for i < n, set by the tests (torch's log and exp)
typedef void (*math_fn)(void* x, int n);
static math_fn LOG[2], EXP[2];  // [float, double]

extern "C" void set_math(math_fn log32, math_fn log64, math_fn exp32, math_fn exp64) {
  LOG[0] = log32; LOG[1] = log64; EXP[0] = exp32; EXP[1] = exp64;
}

template <typename T> static void batch(math_fn f, std::vector<T>& x) {
  if (!x.empty()) f(x.data(), static_cast<int>(x.size()));
}

template <typename T> static Vec3<T> negated(Vec3<T> x, bool dual) {
  return dual ? Vec3<T>{-x.x, -x.y, -x.z} : x;
}

template <typename T> struct Warp {
  ExpCone<T> c[32];
  ExpNode<T> nd[32];
  int queue[32];
  int count = 0, quiet = 0;
  bool drained = false, idle = false, moved = false;
  bool pending[32] = {};  // the node the lane's walk waits on has ended
};

// one warp's walk (every lane reads its cone's nodes before any lane
// restarts its own), then, where a cone is idle and rows may be left, its
// refill from the queue and the cursor; the warp idles where the kernel's
// does
template <typename T>
static void control(Warp<T>& wp, int L, const T* v, const uint8_t* dual, const T* tol,
                    T* out, int n, int max_iter, int& cursor) {
  const int G = 32 / L, t = sizeof(T) == 8;
  const bool more = !(wp.drained && wp.count == 0);
  unsigned done = 0, up = 0;
  for (int i = 0; i < 32; ++i) {
    done |= (wp.nd[i].done ? 1u : 0u) << i;
    up |= (wp.nd[i].done && wp.nd[i].up ? 1u : 0u) << i;
  }
  int step[32];
  T dt[32], lam_c[32];
  for (int i = 0; i < 32; ++i) {
    const int base = i - i % L;
    step[i] = exp_walk(wp.c[i], done >> base, up >> base, L, max_iter);
    const int src = (base + wp.c[i].cur) & 31;
    dt[i] = wp.nd[src].dt;
    lam_c[i] = wp.nd[src].lam_c;
  }
  for (int i = 0; i < 32; ++i) {
    ExpCone<T>& c = wp.c[i];
    if (step[i] == kExpFinish) {
      if (i % L == 0) {
        Vec3<T> p = exp_row_out(Vec3<T>{c.r0, c.s0, c.t0}, c.dual,
                                exp_node_sol(c.r0, c.t0, dt[i], lam_c[i]));
        out[3 * c.row] = p.x; out[3 * c.row + 1] = p.y; out[3 * c.row + 2] = p.z;
      }
      c.phase = kExpIdle;
    } else if (step[i] == kExpRestart) {
      exp_node_start(wp.nd[i], c, exp_node_lam(c, i % L));
    }
  }
  auto all_idle = [&wp]() {
    bool idle = true;
    for (int i = 0; i < 32; ++i) idle = idle && wp.c[i].phase == kExpIdle;
    return idle;
  };
  std::vector<int> need;  // idle cones' first lanes, in lane order
  for (int i = 0; i < G * L; i += L)
    if (wp.c[i].phase == kExpIdle) need.push_back(i);
  const int want = static_cast<int>(need.size());
  if (want == 0 || !more) {
    wp.idle = !more && all_idle();
    return;
  }
  while (want > wp.count && !wp.drained) {
    const int take = want - wp.count, first = cursor;
    cursor += take;
    wp.drained = first >= n - take;
    std::vector<int> rows;
    std::vector<Vec3<T>> u;
    std::vector<T> a, b;
    for (int i = first; i < std::min(first + take, n); ++i) {
      rows.push_back(i);
      u.push_back(negated(Vec3<T>{v[3 * i], v[3 * i + 1], v[3 * i + 2]}, dual[i] != 0));
      a.push_back(exp_cone_arg(u.back()));
      b.push_back(exp_dual_arg(u.back()));
    }
    batch(EXP[t], a);
    batch(EXP[t], b);
    for (size_t k = 0; k < rows.size(); ++k) {
      const int i = rows[k];
      const int cs = exp_case(u[k], a[k], b[k]);
      if (cs == 4) {
        wp.queue[wp.count++] = i;
      } else {
        Vec3<T> p = exp_row_out(u[k], dual[i] != 0, exp_closed_form(cs, u[k]));
        out[3 * i] = p.x; out[3 * i + 1] = p.y; out[3 * i + 2] = p.z;
      }
    }
  }
  int row[32];
  for (int i = 0; i < 32; ++i) row[i] = -1;
  for (int r = 0; r < want; ++r)
    if (r < wp.count) row[need[r]] = wp.queue[wp.count - 1 - r];
  wp.count -= std::min(want, wp.count);
  for (int i = 0; i < G * L; ++i) {
    const int r = row[i - i % L];
    if (r < 0) continue;
    Vec3<T> x3 = negated(Vec3<T>{v[3 * r], v[3 * r + 1], v[3 * r + 2]}, dual[r] != 0);
    exp_cone_start(wp.c[i], x3, tol[r], dual[r] != 0, r);
    exp_node_start(wp.nd[i], wp.c[i], exp_node_lam(wp.c[i], i % L));
  }
  wp.idle = wp.drained && wp.count == 0 && all_idle();
}

// the window's end for one block: once no row is left for it, its live
// cones move, whole lane states, to its first warps where they fill fewer
// warps; true where the block is done
template <typename T>
static bool block_end(Warp<T>* b, int n_warps, int L, int n, int cursor) {
  const int G = 32 / L;
  int total = 0, occupied = 0;
  bool waiting = cursor < n;
  std::vector<ExpCone<T>> cones;
  std::vector<ExpNode<T>> nodes;
  for (int w = 0; w < n_warps; ++w) {
    int live = 0;
    for (int i = 0; i < G * L; i += L)
      if (b[w].c[i].phase != kExpIdle) {
        ++live;
        for (int j = 0; j < L; ++j) {
          cones.push_back(b[w].c[i + j]);
          nodes.push_back(b[w].nd[i + j]);
        }
      }
    total += live;
    occupied += live > 0;
    waiting = waiting || b[w].count > 0;
  }
  if (!waiting && total == 0) return true;
  if (!waiting && (total + G - 1) / G < occupied) {
    for (int w = 0; w < n_warps; ++w) {
      bool all_idle = true;
      for (int i = 0; i < 32; ++i) {
        const int at = (w * G + i / L) * L + i % L;
        if (i < G * L && at < total * L) {
          b[w].c[i] = cones[at];
          b[w].nd[i] = nodes[at];
        } else {
          b[w].c[i].phase = kExpIdle;
          b[w].nd[i] = ExpNode<T>{};
        }
        all_idle = all_idle && b[w].c[i].phase == kExpIdle;
      }
      b[w].drained = true;
      b[w].moved = true;
      b[w].idle = all_idle;
    }
  }
  return false;
}

// the kernel's exp_proj_kernel on n_blocks blocks of block_warps warps in
// lockstep, cones on L lanes, the block's end every window passes; a warp
// walks only where the kernel's does (cones moved to it, an idle cone with
// rows left, half its cones' walks waiting on ended nodes or one for 4
// passes), and a warp with a cone but no walk for kNewtonSteps + 1 passes
// stops the run (the kernel traps there); stats: warp passes, lane Newton
// steps, -1 on a stop
template <typename T>
static void run(const T* v, const uint8_t* dual, const T* tol, T* out, int n, int max_iter,
                int L, int n_blocks, int block_warps, int window, long long* stats) {
  const int t = sizeof(T) == 8, G = 32 / L, n_warps = n_blocks * block_warps;
  std::vector<Warp<T>> W(n_warps);
  for (auto& w : W)
    for (int i = 0; i < 32; ++i) {
      w.c[i] = ExpCone<T>{};
      w.c[i].phase = kExpIdle;
      w.nd[i] = ExpNode<T>{};
    }
  std::vector<bool> finished(n_blocks, false);
  int cursor = 0;
  long long passes = 0, steps = 0;
  while (!std::all_of(finished.begin(), finished.end(), [](bool f) { return f; })) {
    for (int pass = 0; pass < window; ++pass) {
      // one Newton step of every lane's node, the logs in one batch
      std::vector<T> x;
      std::vector<std::pair<int, int>> who;
      std::vector<int> running;
      for (int w = 0; w < n_warps; ++w) {
        if (finished[w / block_warps] || W[w].idle) continue;
        running.push_back(w);
        ++passes;
        for (int i = 0; i < 32; ++i)
          if (W[w].c[i].phase != kExpIdle && !W[w].nd[i].done) {
            x.push_back(exp_newton_arg(W[w].nd[i]));
            who.push_back({w, i});
          }
      }
      batch(LOG[t], x);
      steps += static_cast<long long>(who.size());
      std::vector<std::pair<int, int>> ended;
      std::vector<Vec3<T>> sol;
      std::vector<T> y;
      for (size_t k = 0; k < who.size(); ++k) {
        Warp<T>& w = W[who[k].first];
        const int i = who[k].second;
        if (exp_newton_step(w.nd[i], w.c[i].t0, w.c[i].tol, x[k])) {
          ended.push_back(who[k]);
          sol.push_back(exp_node_sol(w.c[i].r0, w.c[i].t0, w.nd[i].dt, w.nd[i].lam_c));
          y.push_back(exp_g_arg(sol.back()));
        }
      }
      batch(LOG[t], y);
      for (size_t k = 0; k < ended.size(); ++k) {
        Warp<T>& w = W[ended[k].first];
        const int i = ended[k].second;
        w.nd[i].up = exp_g(sol[k], y[k]) > (T)0;
        w.nd[i].done = true;
        w.pending[i] = w.pending[i] || i % L == w.c[i].cur;
      }
      for (int w : running) {
        Warp<T>& wp = W[w];
        bool walk = wp.moved, active = false;
        int waits = 0;
        const bool more = !(wp.drained && wp.count == 0);
        for (int i = 0; i < 32; ++i) {
          const bool leader = i % L == 0 && i < G * L;
          walk = walk || (leader && more && wp.c[i].phase == kExpIdle);
          active = active || wp.c[i].phase != kExpIdle;
          waits += wp.pending[i];
        }
        walk = walk || 2 * waits >= G || (waits && wp.quiet >= 4);
        if (!walk) {
          if (++wp.quiet > kNewtonSteps + 1 && active) {
            stats[0] = stats[1] = -1;
            return;
          }
          continue;
        }
        wp.moved = false;
        for (int i = 0; i < 32; ++i) wp.pending[i] = false;
        wp.quiet = 0;
        control(wp, L, v, dual, tol, out, n, max_iter, cursor);
      }
    }
    for (int b = 0; b < n_blocks; ++b)
      if (!finished[b]) finished[b] = block_end(&W[b * block_warps], block_warps, L, n, cursor);
  }
  stats[0] = passes;
  stats[1] = steps;
}

#define ENTRY(T, SFX)                                                                 \
  extern "C" void exp_sched_##SFX(const T* v, const uint8_t* d, const T* tol, T* out, \
                                  int n, int max_iter, int lanes, int blocks,          \
                                  int block_warps, int window, long long* stats) {     \
    run<T>(v, d, tol, out, n, max_iter, lanes, blocks, block_warps, window, stats);    \
  }
ENTRY(float, f32)
ENTRY(double, f64)
"""

_MATH = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int)


def _torch_math(fn, ctype):
    """A callback that applies the torch function ``fn`` in place to the
    n values of ``ctype`` at a pointer."""
    def apply(ptr, n):
        a = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,))
        a[...] = fn(torch.from_numpy(a.copy())).numpy()
    return _MATH(apply)


@pytest.fixture(scope="module")
def sched(tmp_path_factory):
    """The harness library with torch's log and exp."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's step machine on the host")
    tmp = tmp_path_factory.mktemp("exp_sched")
    src = tmp / "sched.cpp"
    src.write_text(HARNESS)
    so = tmp / "libexp_sched.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib._math = [_torch_math(torch.log, ctypes.c_float), _torch_math(torch.log, ctypes.c_double),
                 _torch_math(torch.exp, ctypes.c_float), _torch_math(torch.exp, ctypes.c_double)]
    lib.set_math(*lib._math)
    return lib


def emulate(lib, V, dual, tol, max_iter, lanes, blocks=2, block_warps=2, window=4):
    """The kernel's rows from the emulation on ``blocks`` blocks of
    ``block_warps`` warps, cones on ``lanes`` lanes, a block's end every
    ``window`` passes, and its (warp passes, lane Newton steps)."""
    V = np.ascontiguousarray(V)
    d = np.ascontiguousarray(dual, dtype=np.uint8)
    tol = np.ascontiguousarray(tol, dtype=V.dtype)
    out = np.full_like(V, 7.0)
    stats = (ctypes.c_longlong * 2)()
    sfx = "f32" if V.dtype == np.float32 else "f64"
    P, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f"exp_sched_{sfx}")(
        P(V.ctypes.data), P(d.ctypes.data), P(tol.ctypes.data), P(out.ctypes.data),
        i(len(V)), i(max_iter), i(lanes), i(blocks), i(block_warps), i(window), stats)
    return out, (stats[0], stats[1])


def same_bits(got, ref):
    """Row-wise: every entry the same bits, or NaN in both."""
    bits = np.uint32 if got.dtype == np.float32 else np.uint64
    eq = (got.view(bits) == ref.view(bits)) | (np.isnan(got) & np.isnan(ref))
    return eq.all(axis=1)


def _check(lib, V, dual, tol, max_iter, lanes, **grid):
    ref = T.project_exp_plain(torch.as_tensor(V), torch.as_tensor(dual),
                              torch.as_tensor(tol), max_iter).numpy()
    got, (passes, _) = emulate(lib, V, dual, tol, max_iter, lanes, **grid)
    assert passes >= 0, "a warp waited with no walk to come"
    bad = np.nonzero(~same_bits(got, ref))[0]
    assert len(bad) == 0, (len(bad), bad[:5], got[bad[:3]], ref[bad[:3]])


def _points(n, seed, dtype):
    """Gaussian rows at scales e^-3 to e^3 (tests/test_torch_exp_pow.py's
    ``_points``), half dual, tolerances 1e-8 and 1e-6."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-3, 3, (n, 1)))
    V[::20, 2] = 1e-9 * np.sign(V[::20, 2])
    dual = rng.random(n) < 0.5
    tol = np.where(rng.random(n) < 0.5, 1e-8, 1e-6)
    return V.astype(dtype), dual, tol.astype(dtype)


def _signed(rows, dtype):
    """``rows`` (the projected point u) as primal rows and as dual rows
    v = -u, whose projection runs on u."""
    U = np.asarray(rows, dtype=np.float64)
    V = np.concatenate([U, -U]).astype(dtype)
    dual = np.r_[np.zeros(len(U), bool), np.ones(len(U), bool)]
    return V, dual


@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_on_gaussian_rows(sched, dtype, lanes):
    V, dual, tol = _points(300, 21, dtype)
    _check(sched, V, dual, tol, 100, lanes)


@pytest.mark.parametrize("max_iter", [1, 2, 3])
@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_when_max_iter_cuts_the_bisection(sched, dtype, lanes,
                                                                 max_iter):
    """A round of 3 or 7 lanes evaluates midpoints past the last step the
    reference takes; the walk stops where it stops."""
    V, dual, tol = _points(120, 22 + max_iter, dtype)
    _check(sched, V, dual, tol, max_iter, lanes)


@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_at_tol_zero(sched, dtype, lanes):
    """tol 0: u - l >= 0 holds on, the bisection runs to max_iter (100)."""
    V, dual, _ = _points(40, 23, dtype)
    _check(sched, V, dual, np.zeros(len(V), dtype), 100, lanes)


# rows u whose bound search reaches its cap of 90 doublings (the first
# three, in both types: g(lambda) > 0 up to 0.125 * 2^90), and rows with
# s0 = -1000, where the inner Newton's first step lands at dt = 0, so s = 0
# and g(lambda) = r0 - lambda exactly: in float64 r0 past 0.125 * 2^90
# reaches the cap, r0 at 2^86-2^88 ends the search at the 88th-90th
# doubling (in float32 lambda^2 overflows first); r0 = 0.375 makes
# g(0.375) = 0 at the bisection's first midpoint, (0.25 + 0.5) / 2
CAP_ROWS = [[3e38, -1e30, 1.0], [1e37, -1e37, 1.0], [1e38, -1e38, 1e-3],
            [1e30, -1000.0, 1.0], [1e27, -1000.0, 2.0], [2.0 ** 86 * 1.5, -1000.0, 1.0],
            [2.0 ** 87 * 1.25, -1000.0, 1.0], [2.0 ** 88 * 0.75, -1000.0, 0.5],
            [2.0 ** 87, -1000.0, 1.0], [3e26, -5.0, 1.0], [1e26, 1.0, 1e3]]
ZERO_ROW = [0.375, -1000.0, 1.0]


@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_at_the_bound_search_cap(sched, dtype, lanes):
    V, dual = _signed(CAP_ROWS, dtype)
    tol = np.full(len(V), 1e-8, dtype)
    U = torch.as_tensor(np.where(dual[:, None], -V, V))
    assert bool((T.exp_in_cone(U, 0.0) | T.exp_in_dual(-U, 0.0)
                 | ((U[:, 0] < 0) & (U[:, 1] < 0))).logical_not().all())   # all case 4
    stats = {}
    T.project_exp_plain(torch.as_tensor(V[:3]), torch.as_tensor(dual[:3]),
                        torch.as_tensor(tol[:3]), 1, stats=stats, per_row=True)
    # the cap's 91 evaluations, then one bisection step
    assert stats["row_evals"].tolist() == [91 + 1] * 3
    _check(sched, V, dual, tol, 100, lanes)
    _check(sched, V, dual, tol, 2, lanes, blocks=1, block_warps=1)


@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_on_nan_and_inf_rows(sched, dtype, lanes):
    nan, inf = np.nan, np.inf
    rows = [[nan, 1.0, 1.0], [1.0, nan, 1.0], [1.0, 1.0, nan], [nan, nan, nan],
            [inf, 1.0, 1.0], [-inf, 1.0, 1.0], [1.0, inf, 1.0], [1.0, -inf, 1.0],
            [1.0, 1.0, inf], [1.0, 1.0, -inf], [inf, -inf, inf], [-inf, inf, -inf],
            [0.5, -1.0, nan], [inf, -1000.0, 1.0], [2.0, -1.0, 0.5]]
    V, dual = _signed(rows, dtype)
    tol = np.where(np.arange(len(V)) % 2 == 0, 1e-8, 1e-6).astype(dtype)
    _check(sched, V, dual, tol, 100, lanes)
    _check(sched, V, dual, tol, 3, lanes)


@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_where_g_is_zero_at_a_midpoint(sched, dtype, lanes):
    V, dual = _signed([ZERO_ROW] * 3, dtype)
    tol = np.full(len(V), 1e-8, dtype)
    U = torch.as_tensor(np.asarray([ZERO_ROW], dtype))
    g, _ = T._exp_grad_dual(torch.tensor([0.375], dtype=torch.float64), U[:, 0], U[:, 1],
                            U[:, 2], torch.as_tensor(tol[:1]))
    assert g.item() == 0.0
    # g = 0 counts as g <= 0: u becomes the midpoint, as in the reference
    _check(sched, V, dual, tol, 100, lanes)
    _check(sched, V, dual, tol, 1, lanes)


@pytest.mark.parametrize("lanes", LANES, ids=str)
def test_schedule_refills_lanes_from_the_queue(sched, lanes):
    """One warp takes every row: its cones are refilled from the queue
    again and again, fewer passes than the rows' serial Newton steps, and
    its lane steps cover them."""
    V, dual, tol = _points(400, 24, np.float64)
    stats = {}
    ref = T.project_exp_plain(torch.as_tensor(V), torch.as_tensor(dual),
                              torch.as_tensor(tol), 100, stats=stats, per_row=True).numpy()
    got, (passes, steps) = emulate(sched, V, dual, tol, 100, lanes, blocks=1, block_warps=1)
    assert same_bits(got, ref).all()
    assert stats["newton"] <= steps <= 32 * passes
    assert passes < stats["newton"]


@pytest.mark.parametrize("grid", [(1, 8, 1), (1, 4, 3), (3, 3, 8), (2, 8, 32), (1, 1, 4)])
@pytest.mark.parametrize("lanes", LANES, ids=str)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_schedule_matches_plain_when_blocks_move_cones(sched, dtype, lanes, grid):
    """More lanes than cones: once the cursor is past the last row, a
    block's live cones move to its first warps at each window's end, Newton
    and walk state and all, and go on there (one warp: nothing to move)."""
    blocks, block_warps, window = grid
    V, dual, tol = _points(150, 25, dtype)
    _check(sched, V, dual, tol, 100, lanes, blocks=blocks, block_warps=block_warps,
           window=window)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_per_row_counts_sum_to_the_totals(dtype):
    """``per_row``: each row's evaluations and Newton steps, 0 in cases 1-3,
    summing to the totals the plain version keeps without it."""
    V, dual, tol = (torch.as_tensor(a) for a in _points(200, 26, dtype))
    totals, per_row = {}, {}
    ref = T.project_exp_plain(V, dual, tol, 100, stats=totals)
    got = T.project_exp_plain(V, dual, tol, 100, stats=per_row, per_row=True)
    assert torch.equal(got, ref)
    for key in ("evals", "newton"):
        assert per_row[key] == totals[key] == int(per_row["row_" + key].sum())
    case4 = torch.as_tensor(np.asarray(PE.case_mix(V, dual)))
    assert int(case4.sum()) == len(V)
    assert int((per_row["row_evals"] > 0).sum()) == int(case4[3])
    # two stacks in one dict: the per-row counts add up as the totals do
    T.project_exp_plain(V, dual, tol, 100, stats=per_row, per_row=True)
    assert per_row["newton"] == 2 * totals["newton"] == int(per_row["row_newton"].sum())


def test_lane_efficiency_and_bit_count_helpers():
    """profile_exp's host reckoning: one thread a row in warps of 32 rows
    in order, each as long as its slowest row; rows whose bits differ (a
    NaN in both is the same, -0 and 0 are not)."""
    steps = torch.tensor([10] + [0] * 31 + [4] * 32 + [2])
    assert PE.thread_layout_efficiency(steps) == (10 + 4 * 32 + 2) / (32 * (10 + 4 + 2))
    assert PE.lane_efficiency(0, 0) == 0.0
    a = torch.tensor([[1.0, float("nan"), 0.0], [1.0, 2.0, 3.0], [0.0, 0.0, 0.0]])
    b = torch.tensor([[1.0, float("nan"), 0.0], [1.0, 2.0, 3.0 + 4e-16], [-0.0, 0.0, 0.0]],
                     dtype=torch.float64).to(a.dtype)
    assert PE.differing_rows(a, b) == 1
    assert PE.differing_rows(a.double(), torch.tensor(
        [[1.0, float("nan"), 0.0], [1.0, 2.0, 3.0 + 4e-16], [-0.0, 0.0, 0.0]],
        dtype=torch.float64)) == 2


def test_recorded_exp_stacks_keep_each_call_and_hand_back_the_count():
    """profile_exp's recorder: each call's rows by reference, the call's
    loop limit, the launch count handed back to the wrapped function, and a
    stack written after its call refused."""
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    V, dual, tol = (torch.as_tensor(a) for a in _points(20, 27, np.float64))
    original, before = K.project_exp, K.project_exp.launches
    try:
        with PE.recorded_stacks("exp") as record:
            assert K.project_exp is not original
            K.project_exp.launches += 2   # the wrapped function counts on this name
            outs = [K.project_exp(V + k, dual, tol, 7) for k in range(3)]
        assert K.project_exp is original and original.launches == before + 2
    finally:
        K.project_exp, original.launches = original, before
    assert record["n"] == len(record["V"]) == 3 and record["max_iter"] == 7
    for k, out in enumerate(outs):
        assert torch.equal(PE.recorded_stack(record, k), V + k)
        assert torch.equal(out, T.project_exp_plain(V + k, dual, tol, 7))
    record["V"][1].add_(1.0)
    with pytest.raises(RuntimeError, match="written after"):
        PE.recorded_stack(record, 1)
    # keep: only the calls named and the last one stay
    with PE.recorded_stacks("exp", keep=(0, 2)) as record:
        for k in range(5):
            K.project_exp(V + k, dual, tol)
    assert record["n"] == 5 and sorted(record["V"]) == [0, 2, 4]
    assert torch.equal(PE.recorded_stack(record, 4), V + 4)
