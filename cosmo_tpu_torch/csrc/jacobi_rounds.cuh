// Round-parallel cyclic Jacobi PSD projection of small symmetric matrices,
// for NVIDIA Hopper (built for sm_90a). One design serves both Jacobi
// kernels of the package; they differ only in their schedule:
//
//   * jacobi_proj.cu    - the round-robin rounds of _round_robin_rounds
//                         (cosmo_tpu/ops/eigh.py), p = min and q = max;
//   * jacobi_proj_rr.cu - the circle-method slot rotation of _slot_rotate
//                         (cosmo_tpu/ops/pallas_eigh.py), p at slot 2t.
//
// Each instantiates this header's register body with its schedule; the
// shared-memory body, the same for both, is jacobi_smem.cu. The three are
// compiled in parallel and linked into one library (ops/cuda_build.py).
//
// For each k x k matrix X of a [B, k, k] stack: `sweeps` sweeps of k - 1
// rounds; a round computes its k/2 angles from the round-start a_pp, a_qq,
// a_pq (the identity rotation when |a_pq| <= 16 * FLT_MIN (DBL_MIN); t = 1
// when tau == 0; sign(0) = 0; NaN carried), then updates the rows p, q of
// every pair, then the columns p, q of X and of V; X <- (X + X^T) / 2 after
// every sweep; out = V max(diag X, 0) V^T. A round's rotations have
// disjoint support, so applying them at once gives the rotations of the
// pair-by-pair order (the TPU's _proj_kernel); only the rounding differs.
//
// What bounds it: per matrix 8 x (k-1) x k/2 rotations of ~18k flops, a
// dependent chain of 8 x (k-1) rounds (120 at k = 16). At B = 2498, k = 16
// a call is ~0.76 GFLOP (11 us in f32, 22 us in f64 at the card's peak) and
// moves ~10 MB in f64 (3 us): the operations bound it. What sets the time
// is the chain and, under it, moving the rows between lanes every round.
//
// Register body (k <= 16, every side the auto rule sends to the kernels).
// Both schedules are one fixed pairing, slots (2t, 2t+1), plus one fixed
// permutation of the slots between rounds, and it is the same permutation:
// the circle rotation 0 -> 0, 1 -> 2 -> 4 -> ... -> k-2 -> k-1 -> k-3 ->
// ... -> 3 -> 1 (for the round-robin rounds, position i of `players` is
// slot 2i and position k-1-i slot 2i+1). The schedules differ in which
// label sits at each slot at the start (slot s / label s, or slot 2i /
// label i and 2i+1 / label k-1-i) and in which label of a pair is p.
//   * k/2 lanes own one matrix; lane t holds the rows of X at slots 2t and
//     2t+1 and the rows 2t, 2t+1 of V, all in registers for every sweep.
//     Columns are held by label and never move: in round r the columns of
//     a pair sit at registers fixed at compile time (rounds are unrolled,
//     k is a template parameter), so a round's column permutation is a
//     register rename, and no integer division is left.
//   * A round: the lane takes its pair's a_pp, a_qq, a_pq, computes the
//     angle (hardware reciprocal and reciprocal square root, refined by
//     Newton: no division, no library call), rotates its two rows
//     (lane-local), publishes (c, s) and reads every pair's, rotates the
//     columns of its rows of X and V (lane-local FMAs), and moves its rows
//     of X to their next slots. Both exchanges go through the matrix's
//     shared-memory tile, each behind one __syncwarp: on the H100 that
//     costs several times less than __shfl_sync, whose throughput set the
//     time of a first version. The tile's row length and the distance
//     between tiles put a row exchange's accesses on distinct banks.
//   * Several matrices share a warp (up to 4 at k = 16, 8 at k = 8); how
//     many is chosen from B, so a small stack still gives every SM's
//     schedulers a warp.
//   * The symmetrization and the reconstruction need transposed entries:
//     they go through the same tile (once a sweep), which also stages the
//     coalesced load and store.
// Shared-memory body (18 <= k <= 48, off the auto rule's path): one warp
// a matrix, X and V in shared memory, the host's pair table (jacobi_smem.cu).
//
// Not used: tensor cores (a round as a k x k product is 2k^3 flops a side,
// ~16x the rotations' work at k = 16) and TMA / cp.async (each matrix is
// read once and written once with coalesced loads; the bytes take 3 us).

#pragma once

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace jacobi {

constexpr int kMaxRegSide = 16;          // the register body's largest k
constexpr int kMaxSide = 48;             // the kernels' largest k
constexpr int kRegWarps = 2;             // warps of a register-body block

template <typename T> struct Limits;
template <> struct Limits<float> {
  static constexpr float tiny16 = FLT_MIN * 16.0f;
  static constexpr float big = 1e18f;     // above it 1 + tau^2 == tau^2
  static constexpr int newton = 1;        // steps after the ~22-bit seed
};
template <> struct Limits<double> {
  static constexpr double tiny16 = DBL_MIN * 16.0;
  static constexpr double big = 1e150;
  static constexpr int newton = 2;
};

// The hardware's approximate 1/x and 1/sqrt(x). The correctly rounded
// library versions branch to a slow-path subroutine, whose calls cost the
// chain time and make ptxas spill around them.
__device__ __forceinline__ float rcp_seed(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return 1.0f / x;
#endif
}
__device__ __forceinline__ double rcp_seed(double x) {
#ifdef __CUDA_ARCH__
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
#else
  return 1.0 / x;
#endif
}
__device__ __forceinline__ float rsqrt_seed(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
#else
  return 1.0f / sqrtf(x);
#endif
}
__device__ __forceinline__ double rsqrt_seed(double x) {
#ifdef __CUDA_ARCH__
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
#else
  return 1.0 / sqrt(x);
#endif
}

// 1/x to about an ulp for normal x (Newton from the seed); 0 for inf
template <typename T>
__device__ __forceinline__ T rcp(T x) {
  const T r0 = rcp_seed(x);
  T r = r0;
#pragma unroll
  for (int i = 0; i < Limits<T>::newton; ++i) r = fma(r, fma(-x, r, T(1)), r);
  return isinf(x) ? r0 : r;
}

// 1/sqrt(x) to about an ulp for x in [1, 2^500)
template <typename T>
__device__ __forceinline__ T rsqrt_nr(T x) {
  T y = rsqrt_seed(x);
#pragma unroll
  for (int i = 0; i < Limits<T>::newton; ++i)
    y = fma(T(0.5) * y, fma(-x * y, y, T(1)), y);
  return y;
}

// (c, s) of the rotation that zeroes a_pq, with the reference's guards: the
// identity when |a_pq| <= 16 tiny; t = sign(tau) / (|tau| + sqrt(1 + tau^2))
// with sign(0) = 0 and NaN carried; t = 1 when tau == 0. Reciprocals and
// square roots are the Newton-refined ones above (an ulp or two off the
// reference's rounding), and sqrt(1 + tau^2) is |tau| for |tau| > big,
// where it rounds to |tau| anyway.
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const bool small = fabs(apq) <= Limits<T>::tiny16;
  const T safe = small ? T(1) : apq;
  const T tau = (aqq - app) * rcp(T(2) * safe);
  const T at = fabs(tau);
  const T q = fma(at, at, T(1));
  const T mag = at < Limits<T>::big ? rcp(fma(q, rsqrt_nr(q), at))  // NaN: not <
                                    : T(0.5) * rcp(at);
  T t = copysign(mag, tau);
  if (tau == T(0)) t = T(1);
  c = rsqrt_nr(fma(t, t, T(1)));
  s = t * c;
  if (small) {
    c = T(1);
    s = T(0);
  }
}

// ---- the slot algebra (compile-time once k and the round are) ----------

// the slot at place m of the circle 1 -> 2 -> 4 -> .. -> k-2 -> k-1 -> .. -> 3
__host__ __device__ constexpr int cycle_slot(int k, int m) {
  return m == 0 ? 1 : (m < k / 2 ? 2 * m : 2 * k - 1 - 2 * m);
}

__host__ __device__ constexpr int cycle_place(int k, int s) {
  return s == 1 ? 0 : (s % 2 == 0 ? s / 2 : (2 * k - 1 - s) / 2);
}

// the slot whose round-0 content sits at slot s after r rounds
__host__ __device__ constexpr int origin(int k, int r, int s) {
  return s == 0 ? 0
                : cycle_slot(k, (cycle_place(k, s) - r % (k - 1) + (k - 1)) % (k - 1));
}

// The schedule of _slot_rotate: slot s starts with label s; p is at slot 2t.
struct SlotRotation {
  static constexpr bool p_is_min = false;
  __host__ __device__ static constexpr int start_label(int, int s) { return s; }
};

// The schedule of _round_robin_rounds: position i of `players` is slot 2i,
// position k-1-i slot 2i+1; p = min, q = max.
struct RoundRobin {
  static constexpr bool p_is_min = true;
  __host__ __device__ static constexpr int start_label(int k, int s) {
    return s % 2 == 0 ? s / 2 : k - 1 - s / 2;
  }
};

// the label at slot s in round r
template <class S>
__host__ __device__ constexpr int label(int k, int r, int s) {
  return S::start_label(k, origin(k, r, s));
}

// does pair u of round r have its p at slot 2u + 1?
template <class S>
__host__ __device__ constexpr bool flipped(int k, int r, int u) {
  return S::p_is_min && label<S>(k, r, 2 * u) > label<S>(k, r, 2 * u + 1);
}

// bit u: pair u of round r is flipped
template <class S>
__host__ __device__ constexpr unsigned flip_mask(int k, int r) {
  unsigned m = 0;
  for (int u = 0; u < k / 2; ++u)
    if (flipped<S>(k, r, u)) m |= 1u << u;
  return m;
}

// ---- register body ------------------------------------------------------

// Columns p, q of one row held by label: (c, s) rotates them.
template <typename T, int K>
__device__ __forceinline__ void rotate_cols(T (&row)[K], int p, int q, T c, T s) {
  const T xp = row[p], xq = row[q];
  row[p] = c * xp - s * xq;
  row[q] = s * xp + c * xq;
}

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

// The row length of a matrix's shared-memory tile and the distance between
// two matrices' tiles, chosen so that the row exchange's accesses (lane t of
// matrix g at slot rows 2t, 2t+1) fall on distinct banks: f64 rows of k + 1
// (two banks an element) and tiles an odd number of elements apart; f32
// rows of k + 2 (at k = 16 slot s starts at bank 2 (9s mod 16)) and tiles
// 1 mod 32 apart.
template <typename T, int K> struct Tile {
  static constexpr int ld = sizeof(T) == 8 ? K + 1 : K + 2;
  static constexpr int used = K * ld + K;  // X or V, then max(w, 0)
  static constexpr int stride =
      sizeof(T) == 8 ? used + 1 - used % 2 : used + (33 - used % 32) % 32;
};

// Where a matrix's lanes exchange data: `rows` holds X's rows by slot (the
// matrix's tile), `cs` the round's (c, s) by pair. Only `live` lanes write.
template <typename T>
struct Exchange {
  T* rows;
  T* cs;
  bool live;
};

// Round R on the rows xt (slot 2t), xb (slot 2t+1) of X and vt, vb (rows
// 2t, 2t+1) of V.
template <typename T, int K, class S, int R>
__device__ __forceinline__ void round_regs(T (&xt)[K], T (&xb)[K], T (&vt)[K],
                                           T (&vb)[K], int t, Exchange<T> ex) {
  constexpr int H = K / 2;
  constexpr int LD = Tile<T, K>::ld;
  // this lane's a_pp, a_qq, a_pq: pair u's entries sit at compile-time
  // registers, row p at the top slot unless the pair is flipped
  T app, aqq, apq;
#pragma unroll
  for (int u = 0; u < H; ++u) {
    if (u == 0 || t == u) {
      const int at_top = label<S>(K, R, 2 * u), at_bot = label<S>(K, R, 2 * u + 1);
      if (flipped<S>(K, R, u)) {
        app = xb[at_bot], aqq = xt[at_top], apq = xb[at_top];
      } else {
        app = xt[at_top], aqq = xb[at_bot], apq = xt[at_bot];
      }
    }
  }
  constexpr unsigned kFlips = flip_mask<S>(K, R);
  const bool flip = (kFlips >> t) & 1u;
  T c, s;
  rotation(app, aqq, apq, c, s);

  // rows p, q: with p at the top slot, top' = c top - s bot and
  // bot' = s top + c bot; with p at the bottom slot s changes sign
  const T sr = flip ? -s : s;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const T top = xt[j], bot = xb[j];
    xt[j] = c * top - sr * bot;
    xb[j] = sr * top + c * bot;
  }

  // every pair's (c, s) through shared memory (shuffles cost the card
  // several times more); the barrier also ends the last reads of `rows`
  if (ex.live) reinterpret_cast<typename Pair<T>::type*>(ex.cs)[t] = {c, s};
  __syncwarp();

  // columns p, q of every pair
#pragma unroll
  for (int u = 0; u < H; ++u) {
    const auto cs = reinterpret_cast<const typename Pair<T>::type*>(ex.cs)[u];
    const int at_top = label<S>(K, R, 2 * u), at_bot = label<S>(K, R, 2 * u + 1);
    const int p = flipped<S>(K, R, u) ? at_bot : at_top;
    const int q = flipped<S>(K, R, u) ? at_top : at_bot;
    rotate_cols(xt, p, q, cs.x, cs.y);
    rotate_cols(xb, p, q, cs.x, cs.y);
    rotate_cols(vt, p, q, cs.x, cs.y);
    rotate_cols(vb, p, q, cs.x, cs.y);
  }

  // the slot rotation of X's rows, through shared memory: slot 2t takes
  // slot 2t-2 (slot 1 for t = 1, its own for t = 0); slot 2t+1 takes slot
  // 2t+3 (slot k-2 for t = k/2 - 1). The barrier also ends the reads of
  // `cs`.
  if (ex.live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ex.rows[(2 * t) * LD + j] = xt[j];
      ex.rows[(2 * t + 1) * LD + j] = xb[j];
    }
  }
  __syncwarp();
  const T* from_top = ex.rows + (t == 0 ? 0 : (t == 1 ? 1 : 2 * t - 2)) * LD;
  const T* from_bot = ex.rows + (t == H - 1 ? K - 2 : 2 * t + 3) * LD;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    xt[j] = from_top[j];
    xb[j] = from_bot[j];
  }
}

template <typename T, int K, class S, int R>
__device__ __forceinline__ void sweep_regs(T (&xt)[K], T (&xb)[K], T (&vt)[K],
                                           T (&vb)[K], int t, Exchange<T> ex) {
  if constexpr (R < K - 1) {
    round_regs<T, K, S, R>(xt, xb, vt, vb, t, ex);
    sweep_regs<T, K, S, R + 1>(xt, xb, vt, vb, t, ex);
  }
}

// Each warp projects `per_warp` consecutive matrices, k/2 lanes each.
template <typename T, int K, class S>
__global__ void __launch_bounds__(32 * kRegWarps, 1)  // all 255 registers
jacobi_proj_regs(const T* __restrict__ x, T* __restrict__ out, int B, int sweeps,
                 int per_warp) {
  constexpr int H = K / 2;
  constexpr int kGroups = 32 / H;        // matrices a warp can hold
  constexpr int LD = Tile<T, K>::ld;
  constexpr int kTile = Tile<T, K>::stride;
  __shared__ T tiles[kRegWarps][kGroups * kTile];
  __shared__ __align__(16) T cs[kRegWarps][kGroups][K];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b0 = (static_cast<long long>(blockIdx.x) * kRegWarps + warp) * per_warp;
  if (b0 >= B) return;  // whole warps only: no block barrier follows
  const int n_here = static_cast<int>(min(static_cast<long long>(per_warp), B - b0));
  const int g = lane / H;
  const int t = lane - g * H;
  const bool live = g < n_here;
  // a lane past the warp's last matrix repeats it and writes nothing
  const int gm = live ? g : n_here - 1;
  T* tile = &tiles[warp][gm * kTile];
  const Exchange<T> ex{tile, &cs[warp][gm][0], live};

  T xt[K], xb[K], vt[K], vb[K];
  const T* xw = x + b0 * K * K;
  for (int e = lane; e < n_here * K * K; e += 32) {
    const int m = e / (K * K), ij = e - m * (K * K);
    tiles[warp][m * kTile + (ij / K) * LD + ij % K] = xw[e];
  }
  __syncwarp();

  const int l_top = S::start_label(K, 2 * t), l_bot = S::start_label(K, 2 * t + 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    xt[j] = tile[l_top * LD + j];
    xb[j] = tile[l_bot * LD + j];
    vt[j] = j == 2 * t ? T(1) : T(0);
    vb[j] = j == 2 * t + 1 ? T(1) : T(0);
  }

  for (int sw = 0; sw < sweeps; ++sw) {
    sweep_regs<T, K, S, 0>(xt, xb, vt, vb, t, ex);
    // the rows are at their starting slots again (period k - 1)
    __syncwarp();
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        tile[l_top * LD + j] = xt[j];
        tile[l_bot * LD + j] = xb[j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < K; ++j) {  // X <- (X + X^T) / 2
      xt[j] = T(0.5) * (xt[j] + tile[j * LD + l_top]);
      xb[j] = T(0.5) * (xb[j] + tile[j * LD + l_bot]);
    }
  }

  // out[i, j] = sum_l V[i, l] max(X[l, l], 0) V[j, l]; the tile holds X
  // (symmetrized, or as loaded when sweeps == 0), whose diagonal is X's
  __syncwarp();
  T* w = tile + K * LD;
  if (live) {
    const T d0 = tile[l_top * LD + l_top], d1 = tile[l_bot * LD + l_bot];
    w[l_top] = d0 < T(0) ? T(0) : d0;  // NaN stays NaN, as jnp.maximum
    w[l_bot] = d1 < T(0) ? T(0) : d1;
  }
  __syncwarp();
  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      tile[(2 * t) * LD + j] = vt[j];
      tile[(2 * t + 1) * LD + j] = vb[j];
    }
  }
  __syncwarp();
  T* ow = out + b0 * K * K;
  for (int e = lane; e < n_here * K * K; e += 32) {
    const int m = e / (K * K), ij = e - m * (K * K);
    const T* V = &tiles[warp][m * kTile];
    const T* wm = V + K * LD;
    const int i = ij / K, j = ij % K;
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < K; ++l) acc += V[i * LD + l] * (wm[l] * V[j * LD + l]);
    ow[e] = acc;
  }
}

template <typename T, int K, class S>
int launch_regs(const T* x, T* out, int B, int sweeps, cudaStream_t stream) {
  constexpr int kGroups = 32 / (K / 2);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  // as many matrices a warp as still leave a warp for each of the card's
  // 4 x SMs schedulers
  int per_warp = (B + 4 * sms - 1) / (4 * sms);
  if (per_warp > kGroups) per_warp = kGroups;
  if (per_warp < 1) per_warp = 1;
  const int warps = (B + per_warp - 1) / per_warp;
  const int grid = (warps + kRegWarps - 1) / kRegWarps;
  jacobi_proj_regs<T, K, S><<<grid, 32 * kRegWarps, 0, stream>>>(
      x, out, B, sweeps, per_warp);
  return static_cast<int>(cudaGetLastError());
}

// ---- shared-memory body (jacobi_smem.cu) ------------------------------

// The shared-memory body for 18 <= k <= 48, with the host's pair table:
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for another
// k. One definition serves both schedules.
int launch_smem(const float* x, float* out, const unsigned char* pairs, int B, int k,
                int sweeps, cudaStream_t stream);
int launch_smem(const double* x, double* out, const unsigned char* pairs, int B, int k,
                int sweeps, cudaStream_t stream);

// ---- dispatch on k ------------------------------------------------------

// The register body for k <= 16 (schedule S, computed at compile time); the
// shared-memory body with the host's pair table above. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a k
// outside even 4..48, B <= 0 or sweeps < 0.
template <typename T, class S, int K = 4>
int launch(const T* x, T* out, const unsigned char* pairs, int B, int k, int sweeps,
           cudaStream_t stream) {
  if (B <= 0 || sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (K > kMaxRegSide) {
    return launch_smem(x, out, pairs, B, k, sweeps, stream);
  } else {
    if (k != K) return launch<T, S, K + 2>(x, out, pairs, B, k, sweeps, stream);
    return launch_regs<T, K, S>(x, out, B, sweeps, stream);
  }
}

}  // namespace jacobi
