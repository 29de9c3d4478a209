// Batched PSD projection of small symmetric matrices by cyclic Jacobi, for
// NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel cosmo_tpu/ops/pallas_eigh.py::_proj_kernel (built
// by _build_proj). For each k x k matrix X of a [B, k, k] stack it applies
// `sweeps` sweeps of the round-robin pair schedule (k-1 rounds of k/2 pairs,
// cosmo_tpu/ops/eigh.py::_round_robin_rounds) SERIALLY, pair after pair:
//   * the angle from the current a_pp, a_qq, a_pq; the identity rotation
//     when |a_pq| <= 16 * FLT_MIN (DBL_MIN); t = 1 when tau == 0;
//   * rows p, q of X, then columns p, q of X, then columns p, q of V;
//   * X <- (X + X^T) / 2 after every sweep;
// and writes the projection out = V max(diag X, 0) V^T straight to global
// memory.
//
// What bounds it on an H100: at B = 512, k = 16 and 8 sweeps one call does
// about 960 rotations x (18k + ~20) flops plus 2k^3 for the reconstruction
// per matrix, ~0.15 GFLOP, and moves ~1 MB (f32). Both bounds are a few
// microseconds; what sets the time is the dependent chain of 960 rotations
// per matrix, each a shared-memory read of three entries, a square root and
// a division, then two rounds of short row/column updates.
//
// What this simple design does about it: one warp owns one matrix, with X
// and V resident in shared memory (rows padded to k + 1) for all sweeps;
// lanes split the k entries of each row/column update and synchronize with
// __syncwarp only, never a block barrier; a block holds up to 4 matrices so
// a 512-matrix stack spreads over ~128 SMs. The latency of the chain is not
// hidden beyond what the warps resident on an SM overlap; doing better
// (registers instead of shared memory, several matrices per warp) is later
// work.
//
// C interface (loaded with ctypes): jacobi_proj_f32 / jacobi_proj_f64 launch
// on the given stream and return cudaGetLastError() as an int.

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
__global__ void jacobi_proj_kernel(const T* __restrict__ x, T* __restrict__ out,
                                   const unsigned char* __restrict__ pairs,
                                   int B, int k, int sweeps, int n_pairs,
                                   int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = k + 1;
  const int mat = k * ld;
  unsigned char* sched = smem + sizeof(T) * 2 * mat * per_block;
  for (int i = threadIdx.x; i < 2 * n_pairs; i += blockDim.x) sched[i] = pairs[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * per_block + warp;
  if (b >= B) return;  // after the only block barrier
  T* X = reinterpret_cast<T*>(smem) + 2 * mat * warp;
  T* V = X + mat;

  const T* xb = x + static_cast<size_t>(b) * k * k;
  for (int e = lane; e < k * k; e += 32) {
    const int i = e / k, j = e - i * k;
    X[i * ld + j] = xb[e];
    V[i * ld + j] = (i == j) ? T(1) : T(0);
  }
  __syncwarp();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int t = 0; t < n_pairs; ++t) {
      const int p = sched[2 * t], q = sched[2 * t + 1];
      const T app = X[p * ld + p], aqq = X[q * ld + q], apq = X[p * ld + q];
      __syncwarp();  // every lane has the angle inputs before rows change
      T c, s;
      rotation(app, aqq, apq, c, s);
      for (int j = lane; j < k; j += 32) {  // rows p, q of X
        const T xp = X[p * ld + j], xq = X[q * ld + j];
        X[p * ld + j] = c * xp - s * xq;
        X[q * ld + j] = s * xp + c * xq;
      }
      __syncwarp();
      for (int i = lane; i < k; i += 32) {  // columns p, q of X and of V
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
  const int n_pairs = (k - 1) * (k / 2);
  const size_t per_mat = 2 * static_cast<size_t>(k) * (k + 1) * sizeof(T);
  const size_t sched_bytes = 2 * static_cast<size_t>(n_pairs);
  int per_block = static_cast<int>((kStaticSmem - sched_bytes) / per_mat);
  if (per_block > kMaxPerBlock) per_block = kMaxPerBlock;
  if (per_block > B) per_block = B;
  if (per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_mat * per_block + sched_bytes;
  const int grid = (B + per_block - 1) / per_block;
  jacobi_proj_kernel<T><<<grid, 32 * per_block, smem, stream>>>(
      x, out, pairs, B, k, sweeps, n_pairs, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jacobi_proj_f32(const float* x, float* out,
                               const unsigned char* pairs, int B, int k,
                               int sweeps, void* stream) {
  return launch<float>(x, out, pairs, B, k, sweeps,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int jacobi_proj_f64(const double* x, double* out,
                               const unsigned char* pairs, int B, int k,
                               int sweeps, void* stream) {
  return launch<double>(x, out, pairs, B, k, sweeps,
                        static_cast<cudaStream_t>(stream));
}
