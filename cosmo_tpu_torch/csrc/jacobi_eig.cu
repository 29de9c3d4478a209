// Warm-started batched eigendecomposition of small symmetric matrices by
// cyclic Jacobi over the round-robin rounds, with the PSD reconstruction, for
// NVIDIA Hopper (built for sm_90a): the Jacobi part of the amortized PSD
// projection.
//
// Replaces the XLA loop of cosmo_tpu/ops/eigh.py::psd_project_amortized
// (jacobi_eigh(W, sweeps, "vec", V0=V_prev), a lax.fori_loop whose trip count
// is a traced scalar, then 0.5 (P + P^T) of V max(w, 0) V^T). It is not a
// TPU kernel: PyTorch has no loop on the device whose trip count is a device
// value, so without a kernel the sweep count would be read on the host every
// projection, or the full sweeps would always run as ~35 launches a round.
// Here every thread reads the count from device memory: `full` when the
// stale flag (computed by torch ops on the card, ops/eigh.amortized_rotate)
// is set, else `warm`.
//
// Design: the round-parallel Jacobi of jacobi_rounds.cuh (the register body
// for k <= 16, jacobi_smem.cu for 18 <= k <= 48), instantiated with kEig:
// the lanes load their rows of V0 in place of the identity, the sweep count
// comes from the device, and after the reconstruction V is stored beside
// 0.5 (P + P^T). The rounds are those of the plain version (ops/eigh.py,
// each round's k/2 disjoint rotations at once), so kernel and plain version
// differ only in rounding. Without kEig the same templates are the
// projections of jacobi_proj.cu and jacobi_proj_rr.cu, unchanged.
//
// Bound (chip_smoke.eig_bound_ms): at k = 16 and B = 2498 a warm call (2
// sweeps) is 0.185 GFLOP in the rotations and 0.021 in the reconstruction
// (2k^3 + k^2 a matrix: P once, then its symmetrisation), 6.05 us in f64 at
// the card's peak, and moves W, V0, P and V once (20.5 MB in f64, 6.11 us):
// the bytes bound it, the operations within 1%; at 8 sweeps the operations,
// 3.7 times the bytes. The kernel sums each entry of P twice (once for each
// side of 0.5 (P + P^T), the plain version's rounding), a k^3 that the
// bound does not count.
//
// C interface (one library with jacobi_proj.cu, jacobi_proj_rr.cu and
// jacobi_smem.cu, loaded with ctypes): jacobi_eig_f32 / jacobi_eig_f64
// launch on the given stream and return cudaGetLastError() as an int.
// `w` and `v0` are [B, k, k] inputs, `p` and `v` [B, k, k] outputs; `pairs`
// is the round-robin table [k-1][k/2][2] (uint8), read for k > 16; `stale`
// is a device byte; `n_full` a device int that counts full-sweep launches
// (or null).

#include "jacobi_rounds.cuh"

template <typename T>
static int jacobi_eig(const T* w, const T* v0, T* p, T* v, const unsigned char* pairs,
                      const unsigned char* stale, int warm, int full, int* n_full,
                      int B, int k, void* stream) {
  jacobi::EigArgs<T> eig;
  eig.v0 = v0;
  eig.v = v;
  eig.stale = stale;
  eig.warm = warm;
  eig.full = full;
  eig.n_full = n_full;
  return jacobi::launch<T, jacobi::RoundRobin, true>(
      w, p, pairs, B, k, 0, static_cast<cudaStream_t>(stream), eig);
}

extern "C" int jacobi_eig_f32(const float* w, const float* v0, float* p, float* v,
                              const unsigned char* pairs, const unsigned char* stale,
                              int warm, int full, int* n_full, int B, int k,
                              void* stream) {
  return jacobi_eig(w, v0, p, v, pairs, stale, warm, full, n_full, B, k, stream);
}

extern "C" int jacobi_eig_f64(const double* w, const double* v0, double* p, double* v,
                              const unsigned char* pairs, const unsigned char* stale,
                              int warm, int full, int* n_full, int B, int k,
                              void* stream) {
  return jacobi_eig(w, v0, p, v, pairs, stale, warm, full, n_full, B, k, stream);
}
