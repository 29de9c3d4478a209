// Batched PSD projection of small symmetric matrices by cyclic Jacobi over
// the round-robin rounds, for NVIDIA Hopper (built for sm_90a).
//
// Replaces the TPU kernel cosmo_tpu/ops/pallas_eigh.py::_proj_kernel (built
// by _build_proj). That kernel applies the round-robin schedule
// (cosmo_tpu/ops/eigh.py::_round_robin_rounds, p = min, q = max) pair after
// pair; here each round's k/2 disjoint rotations are applied at once, which
// gives the same rotations in another rounding order (the kernel's plain
// version, ops/eigh.py, does the same).
//
// Bound (operations; chip_smoke.jacobi_bound_ms): per matrix 8 sweeps of
// (k-1) k/2 rotations of ~18k flops, then 2k^3 for the reconstruction.
// What the design does about the dependent chain: it is 8 (k-1) rounds, not
// 8 (k-1) k/2 rotations; X and V stay in registers, k/2 lanes a matrix and
// several matrices a warp (the RoundRobin schedule of jacobi_rounds.cuh,
// which says how).
//
// C interface (one library with jacobi_proj_rr.cu and jacobi_smem.cu,
// loaded with ctypes): jacobi_proj_f32 / jacobi_proj_f64 launch on the
// given stream and return cudaGetLastError() as an int; `pairs` is the
// round-robin table [k-1][k/2][2] (uint8), read for k > 16.

#include "jacobi_rounds.cuh"

extern "C" int jacobi_proj_f32(const float* x, float* out,
                               const unsigned char* pairs, int B, int k,
                               int sweeps, void* stream) {
  return jacobi::launch<float, jacobi::RoundRobin>(
      x, out, pairs, B, k, sweeps, static_cast<cudaStream_t>(stream));
}

extern "C" int jacobi_proj_f64(const double* x, double* out,
                               const unsigned char* pairs, int B, int k,
                               int sweeps, void* stream) {
  return jacobi::launch<double, jacobi::RoundRobin>(
      x, out, pairs, B, k, sweeps, static_cast<cudaStream_t>(stream));
}
