// Batched PSD projection of small symmetric matrices by ROUND-PARALLEL
// cyclic Jacobi, for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel cosmo_tpu/ops/pallas_eigh.py::_proj_kernel_rr
// (built by _build_proj_rr). For each k x k matrix X of a [B, k, k] stack
// it applies `sweeps` sweeps of k-1 rounds; a round applies its k/2
// disjoint rotations at once:
//   * the k/2 angles from the round-start a_pp, a_qq, a_pq, with the
//     reference's guards: the identity rotation when |a_pq| <= 16 * FLT_MIN
//     (DBL_MIN); t = 1 when tau == 0; sign(0) = 0;
//   * then the rows p, q of X of every pair, then the columns p, q of X and
//     of V of every pair (the reference's order);
//   * X <- (X + X^T) / 2 after every sweep;
// and writes out = V max(diag X, 0) V^T straight to global memory.
//
// The TPU kernel keeps the pairs at slots (2t, 2t+1) and moves the data by
// the circle-method slot rotation between rounds. Here nothing moves: the
// host passes the table of ORIGINAL indices in each slot pair per round
// (uint8 [k-1][k/2][2], cosmo_tpu_torch/ops/jacobi_proj_rr.py pair_table),
// with p the index at slot 2t and q at slot 2t+1, as the TPU kernel has
// them (that order sets the sign of tau). A round's rotations have disjoint
// support, so applying them at relabelled indices is exact; the rotation
// has period k-1, so each sweep ends in the identity layout.
//
// What bounds it on an H100: per matrix and sweep the work is the same
// (k-1) k/2 rotations as the serial kernel's, ~0.15 GFLOP at B = 512,
// k = 16, and a call moves ~2 MB (f32) at B = 2498 — both bounds are a few
// microseconds. What sets the time is the dependent chain: 8 x (k-1) = 120
// rounds at k = 16 (the serial kernel's chain is 960 rotations), each an
// angle step (a square root and two divisions on k/2 lanes) and three
// shared-memory update passes separated by __syncwarp.
//
// What this simple design does about it: one warp owns one matrix, with X,
// V (rows padded to k + 1) and the round's k/2 (c, s) in shared memory for
// all sweeps; lanes t < k/2 compute the angles, then all 32 lanes split the
// k/2 x k row updates, then the k x k/2 column updates of X and of V. Only
// __syncwarp orders them, never a block barrier. A block packs up to 4
// matrices, so B = 2498 spreads over the 132 SMs with several warps each to
// overlap their chains. Registers instead of shared memory, several
// matrices per warp, or a warp-shuffle angle broadcast are later work.
//
// C interface (loaded with ctypes): jacobi_proj_rr_f32 / jacobi_proj_rr_f64
// launch on the given stream and return cudaGetLastError() as an int.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr size_t kStaticSmem = 48 * 1024;  // no opt-in attribute needed
constexpr int kMaxPerBlock = 4;

template <typename T> __device__ __forceinline__ T tiny16();
template <> __device__ __forceinline__ float tiny16<float>() { return FLT_MIN * 16.0f; }
template <> __device__ __forceinline__ double tiny16<double>() { return DBL_MIN * 16.0; }

template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const bool small = fabs(apq) <= tiny16<T>();
  const T safe = small ? T(1) : apq;
  const T tau = (aqq - app) / (T(2) * safe);
  // sign(tau), with sign(0) = 0 and NaN kept, as jnp.sign
  const T sgn = tau > T(0) ? T(1) : (tau < T(0) ? T(-1) : tau);
  T t = sgn / (fabs(tau) + sqrt(T(1) + tau * tau));
  if (tau == T(0)) t = T(1);
  c = T(1) / sqrt(T(1) + t * t);
  s = t * c;
  if (small) {
    c = T(1);
    s = T(0);
  }
}

template <typename T>
__global__ void jacobi_proj_rr_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      const unsigned char* __restrict__ pairs,
                                      int B, int k, int sweeps, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = k + 1;
  const int mat = k * ld;
  const int H = k / 2;
  const int per_warp = 2 * mat + 2 * H;  // X, V, c[H], s[H]
  const int n_table = (k - 1) * k;       // bytes: [k-1][H][2]
  unsigned char* table = smem + sizeof(T) * per_warp * per_block;
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) table[i] = pairs[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * per_block + warp;
  if (b >= B) return;  // after the only block barrier
  T* X = reinterpret_cast<T*>(smem) + per_warp * warp;
  T* V = X + mat;
  T* cs = V + mat;
  T* sn = cs + H;

  const T* xb = x + static_cast<size_t>(b) * k * k;
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e - i * k;
    X[i * ld + j] = xb[e];
    V[i * ld + j] = (i == j) ? T(1) : T(0);
  }
  __syncwarp();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < k - 1; ++r) {
      const unsigned char* pr = table + r * k;
      if (lane < H) {  // the round's angles, from the round-start X
        const int p = pr[2 * lane], q = pr[2 * lane + 1];
        T c, s;
        rotation(X[p * ld + p], X[q * ld + q], X[p * ld + q], c, s);
        cs[lane] = c;
        sn[lane] = s;
      }
      __syncwarp();
      for (int e = lane; e < H * k; e += 32) {  // rows p, q of every pair
        const int t = e / k, j = e - t * k;
        const int p = pr[2 * t], q = pr[2 * t + 1];
        const T c = cs[t], s = sn[t];
        const T xp = X[p * ld + j], xq = X[q * ld + j];
        X[p * ld + j] = c * xp - s * xq;
        X[q * ld + j] = s * xp + c * xq;
      }
      __syncwarp();
      for (int e = lane; e < k * H; e += 32) {  // columns p, q of X and V
        const int i = e / H, t = e - i * H;
        const int p = pr[2 * t], q = pr[2 * t + 1];
        const T c = cs[t], s = sn[t];
        const T xp = X[i * ld + p], xq = X[i * ld + q];
        X[i * ld + p] = c * xp - s * xq;
        X[i * ld + q] = s * xp + c * xq;
        const T vp = V[i * ld + p], vq = V[i * ld + q];
        V[i * ld + p] = c * vp - s * vq;
        V[i * ld + q] = s * vp + c * vq;
      }
      __syncwarp();
    }
    for (int i = lane; i < k; i += 32) {  // X <- (X + X^T) / 2
      for (int j = i + 1; j < k; ++j) {
        const T a = T(0.5) * (X[i * ld + j] + X[j * ld + i]);
        X[i * ld + j] = a;
        X[j * ld + i] = a;
      }
    }
    __syncwarp();
  }

  // out[i, j] = sum_l V[i, l] max(X[l, l], 0) V[j, l]
  T* ob = out + static_cast<size_t>(b) * k * k;
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e - i * k;
    T acc = T(0);
    for (int l = 0; l < k; ++l) {
      const T d = X[l * ld + l];
      const T w = d < T(0) ? T(0) : d;  // NaN stays NaN, as jnp.maximum
      acc += V[i * ld + l] * (w * V[j * ld + l]);
    }
    ob[e] = acc;
  }
}

template <typename T>
int launch(const T* x, T* out, const unsigned char* pairs, int B, int k,
           int sweeps, cudaStream_t stream) {
  if (B <= 0 || k < 4 || k > 48 || (k & 1) || sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t per_mat = (2 * static_cast<size_t>(k) * (k + 1) + k) * sizeof(T);
  const size_t table_bytes = static_cast<size_t>(k - 1) * k;
  int per_block = static_cast<int>((kStaticSmem - table_bytes) / per_mat);
  if (per_block > kMaxPerBlock) per_block = kMaxPerBlock;
  if (per_block > B) per_block = B;
  if (per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_mat * per_block + table_bytes;
  const int grid = (B + per_block - 1) / per_block;
  jacobi_proj_rr_kernel<T><<<grid, 32 * per_block, smem, stream>>>(
      x, out, pairs, B, k, sweeps, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jacobi_proj_rr_f32(const float* x, float* out,
                                  const unsigned char* pairs, int B, int k,
                                  int sweeps, void* stream) {
  return launch<float>(x, out, pairs, B, k, sweeps,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int jacobi_proj_rr_f64(const double* x, double* out,
                                  const unsigned char* pairs, int B, int k,
                                  int sweeps, void* stream) {
  return launch<double>(x, out, pairs, B, k, sweeps,
                        static_cast<cudaStream_t>(stream));
}
