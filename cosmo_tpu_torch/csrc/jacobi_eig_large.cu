// Warm-started batched eigendecomposition of symmetric matrices of the large
// sides (even k = 2 and k > 48) by cyclic Jacobi over the round-robin rounds,
// for NVIDIA Hopper (built for sm_90a): the Jacobi part of the amortized PSD
// projection at the sides that jacobi_eig.cu's bodies (even k 4..48, a
// matrix in one warp's registers or shared memory) do not take.
//
// Replaces, as jacobi_eig.cu does, the XLA loop of
// cosmo_tpu/ops/eigh.py::psd_project_amortized (jacobi_eigh(W, sweeps,
// "vec", V0=V_prev), a lax.fori_loop whose trip count is a traced scalar); it
// is not a TPU kernel. PyTorch has no loop on the device whose trip count is
// a device value, and as torch ops a sweep at k = 896 would be ~13,000
// launches. The function is that of ops/eigh.jacobi_eig_plain before its
// reconstruction: from V0, `full` sweeps when the device byte *stale is set,
// else `warm`, the count read by every thread; each sweep the k - 1 rounds
// of _round_robin_rounds(k), a round's k/2 angles from the round-start
// a_pp, a_qq, a_pq (eigh.rotation_angles, its guards), then the rows p, q of
// W, then the columns p, q of W and of V; W <- (W + W^T) / 2 after each
// sweep; out d = diag W and V. The wrapper
// (ops/jacobi_eig.py) forms P = V max(d, 0) V^T and 0.5 (P + P^T) as a
// batched torch product (eigh.sym_reconstruct), a 2k^3 product that the
// reference also leaves to XLA.
//
// Design. At k = 256 in f64 W and V take 1 MB a matrix, more than a block's
// 227 KB of shared memory, but a bucket's W and V fit in the card's 50 MB L2
// ([8, 256] f64: 8.4 MB; [1, 896] f32: 6.4 MB). So W and V stay in global
// memory, and one cooperative launch (every block co-resident) walks the
// B x (k/2)^2 2x2 tiles {p_i, q_i} x {p_j, q_j} with a grid stride, a grid
// barrier (cooperative_groups) after each round. A round's rotations have
// disjoint support, so tile (i, j) of the new W is G_i^T tile G_j of the old
// W alone, rows first, then columns (the plain version's order), and the V
// entries of rows p_i, q_i and columns p_j, q_j turn by G_j in place: one
// tile a round touches each V entry.
//   * The race. A round's angles read W[p,p], W[q,q] and W[p,q] as they
//     stood at the round's start, while the threads of other tiles overwrite
//     them. W ping-pongs between two scratch buffers (round t reads one and
//     writes the other; the first round reads the input), and each thread
//     computes both of its angles from the buffer it reads: the same inputs
//     and code give every thread the same bits, and a round needs one
//     barrier, where an angle pass would need two.
//   * The symmetrisation is folded into the next sweep's first round, which
//     reads 0.5 (W[a,b] + W[b,a]) for every entry it uses (the plain
//     version's rounding). After the last sweep only the diagonal is read,
//     which the symmetrisation leaves as it is.
//   * Another SM wrote the buffers and V in the previous round: they are
//     read through L2 (__ldcg), never from a stale L1 line.
//   * The plain version's rounding, operation for operation. Each product,
//     sum, quotient and square root is rounded once, as the plain version's
//     torch operations round it (jacobi_rn.cuh: __f*_rn / __d*_rn, no FMA
//     contraction, IEEE division and square root), so on the card kernel
//     and plain version give the same bits. Near its side's limit a Jacobi that has
//     not converged amplifies any rounding difference: with the Newton-
//     refined angle of jacobi_rounds.cuh and FMAs a first version differed
//     from the plain version by up to 1.8e-3 of max |X| in float32 at
//     [1, 896] and 1.5e-4 in float64 at [8, 512] after 8 sweeps from I (an
//     H100), where neither Jacobi has converged.
//   * The pair table is [k-1][k/2][2] uint16 (ops/jacobi_proj.pair_schedule
//     with numpy.uint16): the uint8 table of the small bodies ends at k = 256.
//
// Which sides it keeps. jacobi_eig_cluster.cu holds W in the shared memory
// of one thread-block cluster a matrix (f32 to 896, f64 to 608), and
// jacobi_eig_grid.cu in the shared memory of one cooperative grid of 128
// CTAs, with V's rows (f32 to 1,792, f64 to 1,232); both are faster
// (PERF.md §6: at [1, 640] f64 2 sweeps the grid kernel takes 0.6 of this
// kernel's time on an H100). ops/jacobi_eig.kernel_for sends this kernel
// the even sides past both, up to its pair table's 65,536: there W outgrows
// the grid's shared memory but still fits L2 up to k ~ 1,800 in f64.
//
// What bounds it. The function's work (chip_smoke.eig_bound_ms) bounds it by
// operations, ~0.15 ms for [1, 640] f64 at 2 sweeps. This kernel is a chain
// of sweeps x (k - 1) rounds (1,278 at [1, 640] warm), each a pass over W
// and V through L2 with each angle recomputed by the k/2 threads that use
// it, then a grid barrier (~8 us a round at [1, 640]): the chain, not the
// work, sets its time. Not used: wgmma, TMA, several tiles a thread. It is
// kept as it is for the sides past the grid's bytes, which no cell runs at
// a size where it would pay to redesign it (10j drives it at [1, 1280]).
//
// C interface (in the library of jacobi_proj.cu, loaded with ctypes):
// jacobi_eig_large_f32 / jacobi_eig_large_f64 launch on the given stream and
// return the launch's error or cudaGetLastError() as an int;
// cudaErrorInvalidValue for an odd k, k < 2, B <= 0, warm or full < 0, or a
// null pointer other than n_full. `w` and `v0` are [B, k, k] inputs, `d`
// [B, k] and `v` [B, k, k] outputs, `scratch` [2, B, k, k]; `pairs` the
// uint16 table; `stale` a device byte; `n_full` a device int that counts
// full-sweep launches (or null).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "jacobi_rn.cuh"

namespace cg = cooperative_groups;

namespace jacobi {
namespace {

constexpr int kLargeThreads = 256;

template <typename T>
struct LargeArgs {
  const T* w;
  const T* v0;
  T* d;
  T* v;
  T* buf0;
  T* buf1;
  const unsigned short* pairs;
  const unsigned char* stale;
  int warm;
  int full;
  int* n_full;
  int B;
  int k;
};

// entry (a, b) of the matrix m (rows of k), symmetrised when `sym`
template <typename T>
__device__ __forceinline__ T entry(const T* m, int k, int a, int b, bool sym) {
  const T x = __ldcg(m + static_cast<long long>(a) * k + b);
  return sym ? mul_rn(T(0.5), add_rn(x, __ldcg(m + static_cast<long long>(b) * k + a)))
             : x;
}

template <typename T>
__global__ void __launch_bounds__(kLargeThreads) jacobi_eig_large(LargeArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int k = a.k, h = k / 2;
  const long long kk = static_cast<long long>(k) * k;
  const long long per = static_cast<long long>(h) * h;
  const long long tiles = a.B * per;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int rounds = (*a.stale != 0 ? a.full : a.warm) * (k - 1);

  for (int t = 0; t < rounds; ++t) {
    const int r = t % (k - 1);
    const bool sym = t > 0 && r == 0;
    const T* src = t == 0 ? a.w : ((t - 1) % 2 ? a.buf1 : a.buf0);
    T* dst = t % 2 ? a.buf1 : a.buf0;
    const T* vin = t == 0 ? a.v0 : a.v;
    const unsigned short* pr = a.pairs + static_cast<long long>(r) * k;
    for (long long e = first; e < tiles; e += stride) {
      const long long b = e / per;
      const int ij = static_cast<int>(e - b * per);
      const int i = ij / h, j = ij - i * h;
      const int pi = __ldg(pr + 2 * i), qi = __ldg(pr + 2 * i + 1);
      const int pj = __ldg(pr + 2 * j), qj = __ldg(pr + 2 * j + 1);
      const T* S = src + b * kk;
      T ci, si, cj, sj;
      rotation_rn(entry(S, k, pi, pi, sym), entry(S, k, qi, qi, sym),
                  entry(S, k, pi, qi, sym), ci, si);
      rotation_rn(entry(S, k, pj, pj, sym), entry(S, k, qj, qj, sym),
                  entry(S, k, pj, qj, sym), cj, sj);
      const T xpp = entry(S, k, pi, pj, sym), xpq = entry(S, k, pi, qj, sym);
      const T xqp = entry(S, k, qi, pj, sym), xqq = entry(S, k, qi, qj, sym);
      // rows p_i, q_i: p' = c p - s q, q' = s p + c q
      const T rpp = turn_p(ci, si, xpp, xqp), rpq = turn_p(ci, si, xpq, xqq);
      const T rqp = turn_q(ci, si, xpp, xqp), rqq = turn_q(ci, si, xpq, xqq);
      // then columns p_j, q_j
      T* D = dst + b * kk;
      D[static_cast<long long>(pi) * k + pj] = turn_p(cj, sj, rpp, rpq);
      D[static_cast<long long>(pi) * k + qj] = turn_q(cj, sj, rpp, rpq);
      D[static_cast<long long>(qi) * k + pj] = turn_p(cj, sj, rqp, rqq);
      D[static_cast<long long>(qi) * k + qj] = turn_q(cj, sj, rqp, rqq);
      // V's rows p_i, q_i at the columns p_j, q_j
      const T* Vi = vin + b * kk;
      T* Vo = a.v + b * kk;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const long long o = static_cast<long long>(side == 0 ? pi : qi) * k;
        const T vp = __ldcg(Vi + o + pj), vq = __ldcg(Vi + o + qj);
        Vo[o + pj] = turn_p(cj, sj, vp, vq);
        Vo[o + qj] = turn_q(cj, sj, vp, vq);
      }
    }
    grid.sync();
  }

  const T* last = rounds == 0 ? a.w : ((rounds - 1) % 2 ? a.buf1 : a.buf0);
  for (long long e = first; e < a.B * static_cast<long long>(k); e += stride) {
    const long long b = e / k, l = e - b * k;
    a.d[e] = __ldcg(last + b * kk + l * k + l);
  }
  if (rounds == 0) {
    for (long long e = first; e < a.B * kk; e += stride) a.v[e] = a.v0[e];
  }
  if (a.n_full != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && *a.stale != 0)
    *a.n_full += 1;
}

template <typename T>
int launch_large(LargeArgs<T> args, cudaStream_t stream) {
  if (args.B <= 0 || args.k < 2 || args.k % 2 != 0 || args.warm < 0 || args.full < 0 ||
      !args.w || !args.v0 || !args.d || !args.v || !args.buf0 || !args.pairs ||
      !args.stale)
    return static_cast<int>(cudaErrorInvalidValue);
  // the co-resident blocks of the card, asked once a type
  static int capacity = 0;
  if (capacity == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jacobi_eig_large<T>,
                                                      kLargeThreads, 0) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    capacity = sms * per_sm;
  }
  const long long h = args.k / 2;
  const long long want = (args.B * h * h + kLargeThreads - 1) / kLargeThreads;
  const int grid = static_cast<int>(want < capacity ? want : capacity);
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)jacobi_eig_large<T>, dim3(grid > 0 ? grid : 1),
      dim3(kLargeThreads), params, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T>
int jacobi_eig_large_entry(const T* w, const T* v0, T* d, T* v, T* scratch,
                           const unsigned short* pairs, const unsigned char* stale,
                           int warm, int full, int* n_full, int B, int k, void* stream) {
  LargeArgs<T> args;
  args.w = w;
  args.v0 = v0;
  args.d = d;
  args.v = v;
  args.buf0 = scratch;
  args.buf1 = scratch == nullptr ? nullptr
                                 : scratch + static_cast<long long>(B) * k * k;
  args.pairs = pairs;
  args.stale = stale;
  args.warm = warm;
  args.full = full;
  args.n_full = n_full;
  args.B = B;
  args.k = k;
  return launch_large(args, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace jacobi

extern "C" int jacobi_eig_large_f32(const float* w, const float* v0, float* d, float* v,
                                    float* scratch, const unsigned short* pairs,
                                    const unsigned char* stale, int warm, int full,
                                    int* n_full, int B, int k, void* stream) {
  return jacobi::jacobi_eig_large_entry(w, v0, d, v, scratch, pairs, stale, warm, full,
                                        n_full, B, k, stream);
}

extern "C" int jacobi_eig_large_f64(const double* w, const double* v0, double* d,
                                    double* v, double* scratch,
                                    const unsigned short* pairs,
                                    const unsigned char* stale, int warm, int full,
                                    int* n_full, int B, int k, void* stream) {
  return jacobi::jacobi_eig_large_entry(w, v0, d, v, scratch, pairs, stale, warm, full,
                                        n_full, B, k, stream);
}
