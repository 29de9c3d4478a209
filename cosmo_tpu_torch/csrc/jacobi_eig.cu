// The amortized PSD projection of a stack of small symmetric matrices (even
// sides 4..48) in one launch, for NVIDIA Hopper (built for sm_90a): the
// carried basis re-orthonormalised, W = V'XV, the staleness test over the
// whole stack, the warm-started Jacobi sweeps and the reconstruction.
//
// Replaces the whole of cosmo_tpu/ops/eigh.py::psd_project_amortized (:266),
// which XLA runs as batched products, a reduction and a lax.fori_loop whose
// trip count is a traced scalar; it is not a TPU kernel. The function, that
// of ops/eigh.psd_project_amortized (the plain version):
//   1. V = V_prev (3I - V_prev' V_prev) / 2 (one Newton-Schulz step);
//   2. W = V'(XV), then W <- (W + W') / 2;
//   3. a block is stale when off2 > 0.09 tot2 + tiny (tot2 = sum W^2, off2
//      = tot2 - sum diag(W)^2); the flag is the OR over the stack;
//   4. `full` sweeps from V when it is set, else `warm`: the round-robin
//      rounds of _round_robin_rounds(k), W <- (W + W') / 2 after each sweep;
//   5. P = 0.5 (V max(w, 0) V' + its transpose), w = diag W. Out P and V.
//
// What bounds it (chip_smoke.amortized_bound_ms). At k = 16, B = 2498 in
// f64 a warm call moves X, V_prev, P and V once (20.5 MB, 6.1 us at 3.35
// TB/s) and does 0.19 GFLOP of rotations and 0.10 of products (7.0 us at
// the card's peaks): the operations bound it, the bytes within 15%. What
// sets the time is latency: the sweeps are a dependent chain of 30 rounds
// (each an angle, two exchanges through shared memory and the row and
// column updates), and the stale flag is a reduction over the whole stack
// that decides the sweep count of every matrix.
//
// Design.
//   * One cooperative launch (cudaLaunchCooperativeKernel: every block
//     co-resident, or the launch fails and the wrapper raises) of persistent
//     warps that walk the stack in groups: a group is `per_warp` matrices of
//     one warp in the register body (k <= 16; k/2 lanes a matrix, the rows
//     in registers: jacobi_rounds.cuh's round body and schedule templates),
//     one matrix of one warp in the shared-memory body (18 <= k <= 48, the
//     pair table in shared memory).
//   * The rotation is fused. Register body: a group's X and V_prev go into
//     shared memory by asynchronous copies (cp.async); the Newton-Schulz step
//     and the two products run there with FMAs (full f32 in float32, no
//     TF32), each lane computing the rows it then sweeps, and the group's
//     masses are summed by its lanes; while a group sweeps, the copies of the
//     warp's next group are in flight into the tiles it no longer reads.
//     Shared-memory body: only the two tiles its sweeps need (V_prev, then
//     V; W), each product written in place of an operand only its lane
//     reads, X read from global memory: at k = 48 a first version with four
//     tiles and the copies in flight held a third of the warps an SM and
//     took twice the time of the torch rotation and the earlier kernel
//     (PERF.md §6).
//   * The sweep count is settled on the card without a host read. Full
//     sweeps from V are the warm sweeps followed by full - warm more (the
//     same passes from the same start, so the same rounding): each group
//     runs its `warm` sweeps before the decision (0 when full < warm), each
//     block ORs its groups' staleness into a device flag, and one grid
//     barrier (cooperative groups: the blocks count their arrival on a
//     device counter) precedes the one read of the flag. The last group of
//     each warp keeps its rows in registers (or shared memory) across the
//     barrier; a warp with more groups (a stack beyond one wave) stores the
//     others' W and V in P and V and reloads them after it. The flag has two
//     slots chosen by an epoch word: a launch ORs into slot e, and after the
//     barrier block 0 zeroes slot e + 1 (the next launch's) and advances the
//     epoch, so no second launch or barrier resets it.
//   * Filling the schedulers: the register body takes as many matrices a
//     warp as still leave a warp for each of the card's schedulers (the
//     projection kernels' rule; 4 a warp at [2498, 16], 1.18 warps a
//     scheduler; 8 at [8540, 8], 2.0), more only where the stack would not
//     fit one wave. The fewest a warp that fit one wave (3 at [2498, 16]
//     float64) measured up to 1.4 times slower in float32 and no faster in
//     float64 (PERF.md §6).
//   * Out: P, V, the decided flag as one byte, and one added to *n_full on a
//     full-sweep launch.
//
// C interface (in the library of jacobi_proj.cu, loaded with ctypes):
// jacobi_eig_f32 / jacobi_eig_f64 launch on the given stream and return the
// launch's error or cudaGetLastError() as an int; cudaErrorInvalidValue for
// a k outside even 4..48, B <= 0, warm or full < 0, or a null pointer other
// than n_full. `x` and `v_prev` are [B, k, k] inputs, `p` and `v` [B, k, k]
// outputs; `pairs` is the round-robin table [k-1][k/2][2] (uint8), read for
// k > 16; `stale` a device byte (out); `sync` three device ints (the epoch
// and the flag's two slots), zero before the first launch and left to the
// kernel after it; `n_full` a device int (or null).
// jacobi_eig_wave_f32 / _f64(k, &out): the matrices one wave of the launch
// holds at side k (a larger stack has warps of several groups).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "jacobi_rounds.cuh"

namespace cg = cooperative_groups;

namespace jacobi {
namespace {

constexpr int kEigWarps = 2;     // warps of a block
constexpr int kRegRegions = 3;   // register body: X, V_prev (then V), work
constexpr int kSmemRegions = 2;  // shared-memory body: V_prev (then V), W

template <typename T>
struct EigArgs {
  const T* x;
  const T* v_prev;
  T* p;
  T* v;
  const unsigned char* pairs;
  unsigned char* stale;
  int* sync;  // epoch, flag slot 0, flag slot 1
  int* n_full;
  int warm;
  int full;
  int B;
  int per_warp;
};

template <typename T>
__device__ __forceinline__ T tiny() {
  return Limits<T>::tiny16 / T(16);
}

template <typename T>
__device__ __forceinline__ T clamp0(T d) {
  return d < T(0) ? T(0) : d;  // NaN stays NaN, as torch.clamp
}

// X and V_prev of the matrices b0 .. b0 + n - 1 into the register body's
// tiles xs + m Tile::stride and vs + m Tile::stride, one asynchronous copy
// an element
template <typename T, int K>
__device__ __forceinline__ void load_group(const EigArgs<T>& a, long long b0, int n,
                                           T* xs, T* vs, int lane) {
  const T* x = a.x + b0 * K * K;
  const T* v = a.v_prev + b0 * K * K;
  for (int e = lane; e < n * K * K; e += 32) {
    const int m = e / (K * K), ij = e - m * (K * K);
    const int at = m * Tile<T, K>::stride + (ij / K) * Tile<T, K>::ld + ij % K;
    __pipeline_memcpy_async(xs + at, x + e, sizeof(T));
    __pipeline_memcpy_async(vs + at, v + e, sizeof(T));
  }
  __pipeline_commit();
}

// the flag's decision: each block's OR into slot `epoch`, the grid barrier,
// the one read; block 0 then zeroes the other slot, advances the epoch, and
// writes the decided byte and the tally
template <typename T>
__device__ __forceinline__ bool decide(const EigArgs<T>& a, cg::grid_group& grid,
                                       int epoch, int& block_stale, int& flag_s) {
  __syncthreads();
  if (threadIdx.x == 0 && block_stale) atomicOr(a.sync + 1 + (epoch & 1), 1);
  grid.sync();
  if (threadIdx.x == 0) flag_s = *reinterpret_cast<volatile int*>(a.sync + 1 + (epoch & 1));
  __syncthreads();
  const bool stale = flag_s != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.sync[1 + ((epoch + 1) & 1)] = 0;
    a.sync[0] = epoch + 1;
    *a.stale = stale ? 1 : 0;
    if (stale && a.n_full != nullptr) *a.n_full += 1;
  }
  return stale;
}

// ---- register body (k <= 16) ------------------------------------------

// `n` sweeps of round_regs on the rows held by slot, X <- (X + X') / 2
// after each through the exchange tile
template <typename T, int K>
__device__ __forceinline__ void sweeps_regs(T (&xt)[K], T (&xb)[K], T (&vt)[K],
                                            T (&vb)[K], int t, int l_top, int l_bot,
                                            Exchange<T> ex, int n) {
  constexpr int LD = Tile<T, K>::ld;
  for (int sw = 0; sw < n; ++sw) {
    sweep_regs<T, K, RoundRobin, 0>(xt, xb, vt, vb, t, ex);
    __syncwarp();
    if (ex.live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        ex.rows[l_top * LD + j] = xt[j];
        ex.rows[l_bot * LD + j] = xb[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      xt[j] = T(0.5) * (xt[j] + ex.rows[j * LD + l_top]);
      xb[j] = T(0.5) * (xb[j] + ex.rows[j * LD + l_bot]);
    }
  }
}

// 0.5 (P + P') with P = V max(w, 0) V' for the group's n matrices (their
// work tiles at work + m stride) into p and V into v, from the rows this
// lane holds
template <typename T, int K>
__device__ __forceinline__ void reconstruct_regs(const EigArgs<T>& a, long long b0, int n,
                                                 const T (&xt)[K], const T (&xb)[K],
                                                 const T (&vt)[K], const T (&vb)[K],
                                                 int t, int l_top, int l_bot, bool live,
                                                 T* tile, T* work, int stride, int lane) {
  constexpr int LD = Tile<T, K>::ld;
  __syncwarp();
  T d0 = T(0), d1 = T(0);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j == l_top) d0 = xt[j];
    if (j == l_bot) d1 = xb[j];
  }
  T* w = tile + K * LD;
  if (live) {
    w[l_top] = clamp0(d0);
    w[l_bot] = clamp0(d1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      tile[(2 * t) * LD + j] = vt[j];
      tile[(2 * t + 1) * LD + j] = vb[j];
    }
  }
  __syncwarp();
  T* pw = a.p + b0 * K * K;
  T* vw = a.v + b0 * K * K;
  for (int e = lane; e < n * K * K; e += 32) {
    const int m = e / (K * K), ij = e - m * (K * K);
    const T* V = work + m * stride;
    const T* wm = V + K * LD;
    const int i = ij / K, j = ij % K;
    T acc = T(0), acc_t = T(0);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      acc += V[i * LD + l] * (wm[l] * V[j * LD + l]);
      acc_t += V[j * LD + l] * (wm[l] * V[i * LD + l]);
    }
    pw[e] = T(0.5) * (acc + acc_t);
    vw[e] = V[i * LD + j];
  }
  __syncwarp();
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * kEigWarps, 1) jacobi_eig_regs(EigArgs<T> a) {
  constexpr int H = K / 2;
  constexpr int kGroups = 32 / H;  // matrices a warp can hold
  constexpr int LD = Tile<T, K>::ld;
  constexpr int kTile = Tile<T, K>::stride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) T cs_all[kEigWarps][kGroups][K];
  __shared__ int block_stale, flag_s, epoch_s;
  cg::grid_group grid = cg::this_grid();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pw = a.per_warp;
  // region r of matrix m: base + (r pw + m) kTile (0: X, 1: V_prev then V,
  // 2: products, the rounds' row exchange, the reconstruction)
  T* base = reinterpret_cast<T*>(smem_raw) + static_cast<long long>(warp) * kRegRegions *
                                                 pw * kTile;
  const int g = lane / H;
  const int t = lane - g * H;
  const int l_top = RoundRobin::start_label(K, 2 * t);
  const int l_bot = RoundRobin::start_label(K, 2 * t + 1);
  const long long groups = (a.B + pw - 1) / pw;
  const long long first = static_cast<long long>(blockIdx.x) * kEigWarps + warp;
  const long long step = static_cast<long long>(gridDim.x) * kEigWarps;
  const int pre = a.full >= a.warm ? a.warm : 0;
  if (threadIdx.x == 0) {
    block_stale = 0;
    epoch_s = *reinterpret_cast<volatile int*>(a.sync);
  }
  __syncthreads();
  const int epoch = epoch_s;

  T xt[K], xb[K], vt[K], vb[K];
  long long held = -1;
  if (first < groups)
    load_group<T, K>(a, first * pw,
                     static_cast<int>(min(static_cast<long long>(pw), a.B - first * pw)),
                     base, base + pw * kTile, lane);
  for (long long grp = first; grp < groups; grp += step) {
    const long long b0 = grp * pw;
    const int n_here = static_cast<int>(min(static_cast<long long>(pw), a.B - b0));
    const bool live = g < n_here;
    const int gm = live ? g : n_here - 1;  // a spare lane repeats the last matrix
    T* xs = base + gm * kTile;
    T* vs = base + (pw + gm) * kTile;
    T* ws = base + (2 * pw + gm) * kTile;
    T* cs = &cs_all[warp][gm][0];
    __pipeline_wait_prior(0);
    __syncwarp();

    // 1. A = 3I - V_prev' V_prev, rows 2t and 2t+1, into the work tile
    {
      T m0[K], m1[K];
#pragma unroll
      for (int j = 0; j < K; ++j) m0[j] = m1[j] = T(0);
      for (int l = 0; l < K; ++l) {
        const T a0 = vs[l * LD + 2 * t], a1 = vs[l * LD + 2 * t + 1];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const T b = vs[l * LD + j];
          m0[j] += a0 * b;
          m1[j] += a1 * b;
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          ws[(2 * t) * LD + j] = (j == 2 * t ? T(3) : T(0)) - m0[j];
          ws[(2 * t + 1) * LD + j] = (j == 2 * t + 1 ? T(3) : T(0)) - m1[j];
        }
      }
    }
    __syncwarp();
    // 2. V = 0.5 V_prev A, rows 2t and 2t+1, over V_prev's (each lane
    // reads only its own rows of V_prev here)
#pragma unroll
    for (int j = 0; j < K; ++j) vt[j] = vb[j] = T(0);
    for (int l = 0; l < K; ++l) {
      const T p0 = vs[(2 * t) * LD + l], p1 = vs[(2 * t + 1) * LD + l];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const T b = ws[l * LD + j];
        vt[j] += p0 * b;
        vb[j] += p1 * b;
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      vt[j] *= T(0.5);
      vb[j] *= T(0.5);
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        vs[(2 * t) * LD + j] = vt[j];
        vs[(2 * t + 1) * LD + j] = vb[j];
      }
    }
    __syncwarp();
    // 3. Y = X V, rows 2t and 2t+1, into the work tile (A is read no more)
    {
      T y0[K], y1[K];
#pragma unroll
      for (int j = 0; j < K; ++j) y0[j] = y1[j] = T(0);
      for (int l = 0; l < K; ++l) {
        const T x0 = xs[(2 * t) * LD + l], x1 = xs[(2 * t + 1) * LD + l];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const T b = vs[l * LD + j];
          y0[j] += x0 * b;
          y1[j] += x1 * b;
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          ws[(2 * t) * LD + j] = y0[j];
          ws[(2 * t + 1) * LD + j] = y1[j];
        }
      }
    }
    __syncwarp();
    // 4. W = V' Y, rows l_top and l_bot (the lane's starting slots), then
    // (W + W') / 2 through X's tile (X is read no more)
#pragma unroll
    for (int j = 0; j < K; ++j) xt[j] = xb[j] = T(0);
    for (int l = 0; l < K; ++l) {
      const T c0 = vs[l * LD + l_top], c1 = vs[l * LD + l_bot];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const T y = ws[l * LD + j];
        xt[j] += c0 * y;
        xb[j] += c1 * y;
      }
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        xs[l_top * LD + j] = xt[j];
        xs[l_bot * LD + j] = xb[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < K; ++j) {
      xt[j] = T(0.5) * (xt[j] + xs[j * LD + l_top]);
      xb[j] = T(0.5) * (xb[j] + xs[j * LD + l_bot]);
    }
    // 5. the masses of the lane's rows, summed over the matrix's lanes
    {
      T tot = T(0), d0 = T(0), d1 = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        tot += xt[j] * xt[j];
        tot += xb[j] * xb[j];
        if (j == l_top) d0 = xt[j];
        if (j == l_bot) d1 = xb[j];
      }
      if (live) {
        cs[2 * t] = tot;
        cs[2 * t + 1] = d0 * d0 + d1 * d1;
      }
      __syncwarp();
      if (live && t == 0) {
        T tot2 = T(0), dia2 = T(0);
        for (int u = 0; u < H; ++u) {
          tot2 += cs[2 * u];
          dia2 += cs[2 * u + 1];
        }
        if (tot2 - dia2 > T(0.09) * tot2 + tiny<T>()) block_stale = 1;
      }
      __syncwarp();  // cs is the rounds' angle exchange from here
    }
    // the next group's copies into X's and V_prev's tiles while this one
    // sweeps in registers and the work tile
    const long long next = grp + step;
    if (next < groups)
      load_group<T, K>(a, next * pw,
                       static_cast<int>(min(static_cast<long long>(pw), a.B - next * pw)),
                       base, base + pw * kTile, lane);
    const Exchange<T> ex{ws, cs, live};
    sweeps_regs<T, K>(xt, xb, vt, vb, t, l_top, l_bot, ex, pre);
    if (next < groups) {
      // not the warp's last group: W and V wait in P and V
      if (live) {
        T* P = a.p + (b0 + g) * K * K;
        T* V = a.v + (b0 + g) * K * K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          P[l_top * K + j] = xt[j];
          P[l_bot * K + j] = xb[j];
          V[(2 * t) * K + j] = vt[j];
          V[(2 * t + 1) * K + j] = vb[j];
        }
      }
    } else {
      held = grp;
    }
  }

  const bool stale = decide(a, grid, epoch, block_stale, flag_s);
  const int rest = (stale ? a.full : a.warm) - pre;

  // the held group from its registers, then the stored ones from P and V
  for (long long grp = held; grp >= 0; grp = grp - step >= first ? grp - step : -1) {
    const long long b0 = grp * pw;
    const int n_here = static_cast<int>(min(static_cast<long long>(pw), a.B - b0));
    const bool live = g < n_here;
    const int gm = live ? g : n_here - 1;
    T* ws = base + (2 * pw + gm) * kTile;
    if (grp != held) {
      const T* P = a.p + (b0 + gm) * K * K;
      const T* V = a.v + (b0 + gm) * K * K;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        xt[j] = P[l_top * K + j];
        xb[j] = P[l_bot * K + j];
        vt[j] = V[(2 * t) * K + j];
        vb[j] = V[(2 * t + 1) * K + j];
      }
    }
    const Exchange<T> ex{ws, &cs_all[warp][gm][0], live};
    sweeps_regs<T, K>(xt, xb, vt, vb, t, l_top, l_bot, ex, rest);
    reconstruct_regs<T, K>(a, b0, n_here, xt, xb, vt, vb, t, l_top, l_bot, live, ws,
                           base + 2 * pw * kTile, kTile, lane);
  }
}

// ---- shared-memory body (18 <= k <= 48) --------------------------------

// `n` sweeps on W and V in shared memory (rows of K + 1), the round-robin
// pair table in shared memory: jacobi_smem.cu's rounds
template <typename T, int K>
__device__ __forceinline__ void sweeps_smem(T* X, T* V, const unsigned char* table,
                                            int n, int lane) {
  constexpr int H = K / 2;
  constexpr int LD = K + 1;
  for (int sw = 0; sw < n; ++sw) {
    for (int r = 0; r < K - 1; ++r) {
      const unsigned char* pr = table + r * K;
      T c = T(1), s = T(0);
      if (lane < H) {  // the round's angles, from the round-start X
        const int p = pr[2 * lane], q = pr[2 * lane + 1];
        rotation(X[p * LD + p], X[q * LD + q], X[p * LD + q], c, s);
      }
      __syncwarp();
      for (int e0 = 0; e0 < H * K; e0 += 32) {  // rows p, q of every pair
        const int e = e0 + lane;
        const bool ok = e < H * K;
        const int u = ok ? e / K : 0, j = e - u * K;
        const T cu = __shfl_sync(0xffffffffu, c, u);
        const T su = __shfl_sync(0xffffffffu, s, u);
        if (ok) {
          const int p = pr[2 * u], q = pr[2 * u + 1];
          const T xp = X[p * LD + j], xq = X[q * LD + j];
          X[p * LD + j] = cu * xp - su * xq;
          X[q * LD + j] = su * xp + cu * xq;
        }
      }
      __syncwarp();
      for (int e0 = 0; e0 < K * H; e0 += 32) {  // columns p, q of X and V
        const int e = e0 + lane;
        const bool ok = e < K * H;
        const int i = ok ? e / H : 0, u = ok ? e - i * H : 0;
        const T cu = __shfl_sync(0xffffffffu, c, u);
        const T su = __shfl_sync(0xffffffffu, s, u);
        if (ok) {
          const int p = pr[2 * u], q = pr[2 * u + 1];
          const T xp = X[i * LD + p], xq = X[i * LD + q];
          X[i * LD + p] = cu * xp - su * xq;
          X[i * LD + q] = su * xp + cu * xq;
          const T vp = V[i * LD + p], vq = V[i * LD + q];
          V[i * LD + p] = cu * vp - su * vq;
          V[i * LD + q] = su * vp + cu * vq;
        }
      }
      __syncwarp();
    }
    for (int i = lane; i < K; i += 32) {  // X <- (X + X') / 2
      for (int j = i + 1; j < K; ++j) {
        const T h = T(0.5) * (X[i * LD + j] + X[j * LD + i]);
        X[i * LD + j] = h;
        X[j * LD + i] = h;
      }
    }
    __syncwarp();
  }
}

// The rotation of matrix b in two tiles (rows of K + 1): V_prev in `vs`
// becomes V, and W = (V'XV + (V'XV)') / 2 ends in `ws`; X is read from
// global memory. A lane takes the columns (or rows) lane and lane + 32 of a
// product, its K sums in registers over one pass of the shared operand's
// rows (read by every lane at once), and writes them in place of the
// column (row) of the operand that it alone reads.
template <typename T, int K>
__device__ __forceinline__ void rotate_smem(const EigArgs<T>& a, long long b, T* vs, T* ws,
                                            int lane) {
  constexpr int LD = K + 1;
  const T* x = a.x + b * K * K;
  for (int e = lane; e < K * K; e += 32) vs[(e / K) * LD + e % K] = a.v_prev[b * K * K + e];
  __syncwarp();
  T acc[K];
  // A = 3I - V_prev' V_prev, column j
  for (int j = lane; j < K; j += 32) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = T(0);
    for (int l = 0; l < K; ++l) {
      const T c = vs[l * LD + j];
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] += vs[l * LD + i] * c;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) ws[i * LD + j] = (i == j ? T(3) : T(0)) - acc[i];
  }
  __syncwarp();
  // V = 0.5 V_prev A, row i, over V_prev's row i
  for (int i = lane; i < K; i += 32) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = T(0);
    for (int l = 0; l < K; ++l) {
      const T r = vs[i * LD + l];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] += r * ws[l * LD + j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) vs[i * LD + j] = T(0.5) * acc[j];
  }
  __syncwarp();
  // Y = X V, row i, over A's (read no more)
  for (int i = lane; i < K; i += 32) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[j] = T(0);
    for (int l = 0; l < K; ++l) {
      const T r = x[i * K + l];
#pragma unroll
      for (int j = 0; j < K; ++j) acc[j] += r * vs[l * LD + j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) ws[i * LD + j] = acc[j];
  }
  __syncwarp();
  // W = V' Y, column j, over Y's column j
  for (int j = lane; j < K; j += 32) {
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = T(0);
    for (int l = 0; l < K; ++l) {
      const T c = ws[l * LD + j];
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] += vs[l * LD + i] * c;
    }
#pragma unroll
    for (int i = 0; i < K; ++i) ws[i * LD + j] = acc[i];
  }
  __syncwarp();
  for (int e = lane; e < K * K; e += 32) {  // (W + W') / 2
    const int i = e / K, j = e % K;
    if (i < j) {
      const T h = T(0.5) * (ws[i * LD + j] + ws[j * LD + i]);
      ws[i * LD + j] = h;
      ws[j * LD + i] = h;
    }
  }
  __syncwarp();
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * kEigWarps, 1) jacobi_eig_smem(EigArgs<T> a) {
  constexpr int LD = K + 1;
  constexpr int kRegion = K * LD;
  constexpr int kTable = (K - 1) * K;  // bytes: [k-1][k/2][2]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned char table[kTable];
  __shared__ int block_stale, flag_s, epoch_s;
  cg::grid_group grid = cg::this_grid();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warp's two tiles: V (V_prev first), W
  T* vs = reinterpret_cast<T*>(smem_raw) + warp * kSmemRegions * kRegion;
  T* ws = vs + kRegion;
  const long long first = static_cast<long long>(blockIdx.x) * kEigWarps + warp;
  const long long step = static_cast<long long>(gridDim.x) * kEigWarps;
  const int pre = a.full >= a.warm ? a.warm : 0;
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) table[i] = a.pairs[i];
  if (threadIdx.x == 0) {
    block_stale = 0;
    epoch_s = *reinterpret_cast<volatile int*>(a.sync);
  }
  __syncthreads();
  const int epoch = epoch_s;

  long long held = -1;
  for (long long b = first; b < a.B; b += step) {
    rotate_smem<T, K>(a, b, vs, ws, lane);
    T tot = T(0), dia = T(0);  // the masses
    for (int e = lane; e < K * K; e += 32) {
      const int i = e / K, j = e % K;
      const T w = ws[i * LD + j];
      tot += w * w;
      if (i == j) dia += w * w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
      dia += __shfl_xor_sync(0xffffffffu, dia, o);
    }
    if (lane == 0 && tot - dia > T(0.09) * tot + tiny<T>()) block_stale = 1;
    sweeps_smem<T, K>(ws, vs, table, pre, lane);
    if (b + step < a.B) {
      // not the warp's last matrix: W and V wait in P and V
      for (int e = lane; e < K * K; e += 32) {
        const int i = e / K, j = e % K;
        a.p[b * K * K + e] = ws[i * LD + j];
        a.v[b * K * K + e] = vs[i * LD + j];
      }
      __syncwarp();
    } else {
      held = b;
    }
  }

  const bool stale = decide(a, grid, epoch, block_stale, flag_s);
  const int rest = (stale ? a.full : a.warm) - pre;

  for (long long b = held; b >= 0; b = b - step >= first ? b - step : -1) {
    if (b != held) {
      for (int e = lane; e < K * K; e += 32) {
        const int i = e / K, j = e % K;
        ws[i * LD + j] = a.p[b * K * K + e];
        vs[i * LD + j] = a.v[b * K * K + e];
      }
      __syncwarp();
    }
    sweeps_smem<T, K>(ws, vs, table, rest, lane);
    for (int e = lane; e < K * K; e += 32) {
      const int i = e / K, j = e % K;
      T acc = T(0), acc_t = T(0);
      for (int l = 0; l < K; ++l) {
        const T w = clamp0(ws[l * LD + l]);
        acc += vs[i * LD + l] * (w * vs[j * LD + l]);
        acc_t += vs[j * LD + l] * (w * vs[i * LD + l]);
      }
      a.p[b * K * K + e] = T(0.5) * (acc + acc_t);
      a.v[b * K * K + e] = vs[i * LD + j];
    }
    __syncwarp();
  }
}

// ---- launch -------------------------------------------------------------

template <int K>
constexpr bool kRegBody = K <= kMaxRegSide;

template <typename T, int K>
constexpr int max_per_warp() {
  return kRegBody<K> ? 32 / (K / 2) : 1;
}

template <typename T, int K>
size_t smem_bytes(int per_warp) {
  if constexpr (kRegBody<K>)
    return sizeof(T) * static_cast<size_t>(kEigWarps) * kRegRegions * per_warp *
           Tile<T, K>::stride;
  else
    return sizeof(T) * static_cast<size_t>(kEigWarps) * kSmemRegions * K * (K + 1);
}

template <typename T, int K>
const void* kernel_of() {
  if constexpr (kRegBody<K>)
    return reinterpret_cast<const void*>(jacobi_eig_regs<T, K>);
  else
    return reinterpret_cast<const void*>(jacobi_eig_smem<T, K>);
}

// the card's SMs, asked once (0 on an error)
int sm_count() {
  static int sms = 0;
  int dev = 0;
  if (sms == 0 && (cudaGetDevice(&dev) != cudaSuccess ||
                   cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                       cudaSuccess))
    return 0;
  return sms;
}

// the blocks the card holds at once with `per_warp` matrices a warp
// (0 on an error), asked once an instantiation and per_warp
template <typename T, int K>
int capacity(int per_warp) {
  static int blocks[33] = {0};
  static bool sized = false;
  if (blocks[per_warp] == 0) {
    const void* fn = kernel_of<T, K>();
    int per_sm = 0;
    if (!sized && cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_bytes<T, K>(
                                           max_per_warp<T, K>()))) != cudaSuccess)
      return 0;
    sized = true;
    if (sm_count() == 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * kEigWarps,
                                                      smem_bytes<T, K>(per_warp)) !=
            cudaSuccess)
      return 0;
    blocks[per_warp] = sm_count() * per_sm;
  }
  return blocks[per_warp];
}

// matrices a warp: as many as still leave a warp for each of the card's 4 x
// SMs schedulers (the projection kernels' rule), more where the stack would
// not fit one wave, at most a warp's worth (its warps then walk several
// groups); 0 on an error
template <typename T, int K>
int per_warp_for(long long B) {
  const long long schedulers = 4LL * sm_count();
  if (schedulers == 0) return 0;
  int pw = static_cast<int>((B + schedulers - 1) / schedulers);
  for (pw = pw < 1 ? 1 : pw; pw < max_per_warp<T, K>(); ++pw) {
    const long long blocks = ((B + pw - 1) / pw + kEigWarps - 1) / kEigWarps;
    const int cap = capacity<T, K>(pw);
    if (cap == 0) return 0;
    if (blocks <= cap) return pw;
  }
  return max_per_warp<T, K>();
}

template <typename T, int K>
int launch_eig(EigArgs<T> a, cudaStream_t stream) {
  const int pw = per_warp_for<T, K>(a.B);
  const int cap = pw > 0 ? capacity<T, K>(pw) : 0;
  if (cap == 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  a.per_warp = pw;
  const long long want = ((a.B + pw - 1) / pw + kEigWarps - 1) / kEigWarps;
  const int grid = static_cast<int>(want < cap ? want : cap);
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel_of<T, K>(), dim3(grid), dim3(32 * kEigWarps), params, smem_bytes<T, K>(pw),
      stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T, int K = 4>
int dispatch(const EigArgs<T>& a, int k, cudaStream_t stream) {
  if constexpr (K > kMaxSide) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return dispatch<T, K + 2>(a, k, stream);
    if (K > kMaxRegSide && a.pairs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_eig<T, K>(a, stream);
  }
}

template <typename T, int K = 4>
int wave(int k, int* out) {
  if constexpr (K > kMaxSide) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return wave<T, K + 2>(k, out);
    const int cap = capacity<T, K>(max_per_warp<T, K>());
    if (cap == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    *out = cap * kEigWarps * max_per_warp<T, K>();
    return 0;
  }
}

template <typename T>
int jacobi_eig_entry(const T* x, const T* v_prev, T* p, T* v, const unsigned char* pairs,
                     unsigned char* stale, int* sync, int warm, int full, int* n_full,
                     int B, int k, void* stream) {
  if (B <= 0 || warm < 0 || full < 0 || !x || !v_prev || !p || !v || !stale || !sync)
    return static_cast<int>(cudaErrorInvalidValue);
  EigArgs<T> a;
  a.x = x;
  a.v_prev = v_prev;
  a.p = p;
  a.v = v;
  a.pairs = pairs;
  a.stale = stale;
  a.sync = sync;
  a.n_full = n_full;
  a.warm = warm;
  a.full = full;
  a.B = B;
  a.per_warp = 1;
  return dispatch<T>(a, k, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace jacobi

extern "C" int jacobi_eig_f32(const float* x, const float* v_prev, float* p, float* v,
                              const unsigned char* pairs, unsigned char* stale, int* sync,
                              int warm, int full, int* n_full, int B, int k, void* stream) {
  return jacobi::jacobi_eig_entry(x, v_prev, p, v, pairs, stale, sync, warm, full, n_full,
                                  B, k, stream);
}

extern "C" int jacobi_eig_f64(const double* x, const double* v_prev, double* p, double* v,
                              const unsigned char* pairs, unsigned char* stale, int* sync,
                              int warm, int full, int* n_full, int B, int k, void* stream) {
  return jacobi::jacobi_eig_entry(x, v_prev, p, v, pairs, stale, sync, warm, full, n_full,
                                  B, k, stream);
}

extern "C" int jacobi_eig_wave_f32(int k, int* out) { return jacobi::wave<float>(k, out); }

extern "C" int jacobi_eig_wave_f64(int k, int* out) { return jacobi::wave<double>(k, out); }
