// Batched PSD projection of small symmetric matrices by round-parallel
// cyclic Jacobi over the circle-method slot rotation, for NVIDIA Hopper
// (built for sm_90a).
//
// Replaces the TPU kernel cosmo_tpu/ops/pallas_eigh.py::_proj_kernel_rr
// (built by _build_proj_rr). That kernel keeps the pairs at slots
// (2t, 2t+1), with p at slot 2t, and moves the matrix by _slot_rotate
// between rounds; here the rows move between lanes by the same rotation and
// the columns are renamed at compile time (the SlotRotation schedule of
// jacobi_rounds.cuh, which says how).
//
// Bound (operations; chip_smoke.jacobi_bound_ms): the same rotations as
// jacobi_proj.cu. What the design does about the dependent chain of
// 8 (k-1) rounds: X and V stay in registers, k/2 lanes a matrix and
// several matrices a warp.
//
// C interface (one library with jacobi_proj.cu and jacobi_smem.cu, loaded
// with ctypes): jacobi_proj_rr_f32 / jacobi_proj_rr_f64 launch on the given
// stream and return cudaGetLastError() as an int;
// `pairs` is ops/jacobi_proj_rr.py's pair_table [k-1][k/2][2] (uint8),
// read for k > 16.

#include "jacobi_rounds.cuh"

extern "C" int jacobi_proj_rr_f32(const float* x, float* out,
                                  const unsigned char* pairs, int B, int k,
                                  int sweeps, void* stream) {
  return jacobi::launch<float, jacobi::SlotRotation>(
      x, out, pairs, B, k, sweeps, static_cast<cudaStream_t>(stream));
}

extern "C" int jacobi_proj_rr_f64(const double* x, double* out,
                                  const unsigned char* pairs, int B, int k,
                                  int sweeps, void* stream) {
  return jacobi::launch<double, jacobi::SlotRotation>(
      x, out, pairs, B, k, sweeps, static_cast<cudaStream_t>(stream));
}
