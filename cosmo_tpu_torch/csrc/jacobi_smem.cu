// The shared-memory body of the Jacobi projection kernels, for the sides
// 18 <= k <= 48 (off the auto rule's path, inside the kernels' domain). Both
// schedules run it with their host pair table, so it is compiled once, into
// the same library as jacobi_proj.cu and jacobi_proj_rr.cu (jacobi_rounds.cuh
// says what the design is and what bounds it).
//
// One warp owns a matrix, X and V (rows padded to k + 1) in shared memory;
// lanes t < k/2 compute the round's angles from the pair table
// ([k-1][k/2][2] uint8) and broadcast them by __shfl_sync; all lanes split
// the row updates, then the column updates, ordered by __syncwarp. k is a
// template parameter, so no integer division is left.

#include "jacobi_rounds.cuh"

namespace jacobi {

constexpr int kSmemMaxPerBlock = 4;  // matrices of a block
constexpr size_t kStaticSmem = 48 * 1024;

template <typename T, int K>
__global__ void __launch_bounds__(32 * kSmemMaxPerBlock)
jacobi_proj_smem(const T* __restrict__ x, T* __restrict__ out,
                 const unsigned char* __restrict__ pairs, int B, int sweeps,
                 int per_block) {
  constexpr int H = K / 2;
  constexpr int LD = K + 1;
  constexpr int MAT = K * LD;
  constexpr int kTable = (K - 1) * K;  // bytes: [k-1][k/2][2]
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* table = smem + sizeof(T) * 2 * MAT * per_block;
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) table[i] = pairs[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * per_block + warp;
  if (b >= B) return;  // after the only block barrier
  T* X = reinterpret_cast<T*>(smem) + 2 * MAT * warp;
  T* V = X + MAT;

  const T* xb = x + static_cast<size_t>(b) * K * K;
  for (int e = lane; e < K * K; e += 32) {
    const int i = e / K, j = e % K;
    X[i * LD + j] = xb[e];
    V[i * LD + j] = i == j ? T(1) : T(0);
  }
  __syncwarp();

  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < K - 1; ++r) {
      const unsigned char* pr = table + r * K;
      T c = T(1), s = T(0);
      if (lane < H) {  // the round's angles, from the round-start X
        const int p = pr[2 * lane], q = pr[2 * lane + 1];
        rotation(X[p * LD + p], X[q * LD + q], X[p * LD + q], c, s);
      }
      __syncwarp();
      // rows p, q of every pair; the loop's trip count is the same for
      // every lane, so every lane takes part in each shuffle
      for (int e0 = 0; e0 < H * K; e0 += 32) {
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
    for (int i = lane; i < K; i += 32) {  // X <- (X + X^T) / 2
      for (int j = i + 1; j < K; ++j) {
        const T a = T(0.5) * (X[i * LD + j] + X[j * LD + i]);
        X[i * LD + j] = a;
        X[j * LD + i] = a;
      }
    }
    __syncwarp();
  }

  // out[i, j] = sum_l V[i, l] max(X[l, l], 0) V[j, l]
  T* ob = out + static_cast<size_t>(b) * K * K;
  for (int e = lane; e < K * K; e += 32) {
    const int i = e / K, j = e % K;
    T acc = T(0);
    for (int l = 0; l < K; ++l) {
      const T d = X[l * LD + l];
      const T w = d < T(0) ? T(0) : d;  // NaN stays NaN, as jnp.maximum
      acc += V[i * LD + l] * (w * V[j * LD + l]);
    }
    ob[e] = acc;
  }
}

template <typename T, int K>
int launch_side(const T* x, T* out, const unsigned char* pairs, int B, int sweeps,
                cudaStream_t stream) {
  const size_t per_mat = 2 * static_cast<size_t>(K) * (K + 1) * sizeof(T);
  const size_t table_bytes = static_cast<size_t>(K - 1) * K;
  int per_block = static_cast<int>((kStaticSmem - table_bytes) / per_mat);
  if (per_block > kSmemMaxPerBlock) per_block = kSmemMaxPerBlock;
  if (per_block > B) per_block = B;
  if (per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_mat * per_block + table_bytes;
  const int grid = (B + per_block - 1) / per_block;
  jacobi_proj_smem<T, K><<<grid, 32 * per_block, smem, stream>>>(
      x, out, pairs, B, sweeps, per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K = kMaxRegSide + 2>
int dispatch(const T* x, T* out, const unsigned char* pairs, int B, int k, int sweeps,
             cudaStream_t stream) {
  if constexpr (K > kMaxSide) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (k != K) return dispatch<T, K + 2>(x, out, pairs, B, k, sweeps, stream);
    return launch_side<T, K>(x, out, pairs, B, sweeps, stream);
  }
}

int launch_smem(const float* x, float* out, const unsigned char* pairs, int B, int k,
                int sweeps, cudaStream_t stream) {
  return dispatch<float>(x, out, pairs, B, k, sweeps, stream);
}

int launch_smem(const double* x, double* out, const unsigned char* pairs, int B, int k,
                int sweeps, cudaStream_t stream) {
  return dispatch<double>(x, out, pairs, B, k, sweeps, stream);
}

}  // namespace jacobi
