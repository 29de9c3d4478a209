// Exponential- and power-cone projection on Hopper: one thread per cone.
//
// Replaces the JAX package's one jax.vmap of nested lax.while_loop over
// every cone of a family (cosmo_tpu/ops/exp_pow.py:133 project_exp, :213
// project_pow), which XLA runs as a loop on the device with a predicate a
// lane. Not a TPU kernel (the JAX package has no Pallas kernel for it): a
// PyTorch version of those loops needs a host read a step, or up to ~28,500
// masked Newton steps of ~15 launches each, for every ADMM iteration.
//
// What bounds it on an H100: not bytes (65,122 cones in float64 are 1.6 MB
// in and out, 0.5 us at 3.35 TB/s) but the chain of dependent operations a
// thread runs: a bound search of up to 90 steps and a bisection of up to
// max_iter steps, each around an inner Newton of up to 150 steps with a
// log, a division and (for pow) two powers a step. So the design keeps the
// cone, its tolerance and every loop's state in registers, reads each
// input once and writes each output once, and lets each thread leave its
// loops on its own condition: threads of a warp that finish early idle
// until the warp's slowest cone is done, which is the price of the
// data-dependent loop lengths (a Triton block would run every lane to the
// longest loop of its block).
//
// The body (exp_pow_body.cuh) is the reference's lane function operation
// by operation; it also compiles as host C++ for the CPU tests.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exp_pow_body.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
exp_proj_kernel(const T* __restrict__ v, const uint8_t* __restrict__ is_dual,
                const T* __restrict__ tol, T* __restrict__ out, int n, int max_iter) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  exp_pow::Vec3<T> x{v[3 * i], v[3 * i + 1], v[3 * i + 2]};
  exp_pow::Vec3<T> p = exp_pow::project_exp_row(x, is_dual[i] != 0, tol[i], max_iter);
  out[3 * i] = p.x;
  out[3 * i + 1] = p.y;
  out[3 * i + 2] = p.z;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pow_proj_kernel(const T* __restrict__ v, const T* __restrict__ alpha,
                const uint8_t* __restrict__ is_dual, const T* __restrict__ tol,
                T* __restrict__ out, int n, int max_iter) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  exp_pow::Vec3<T> x{v[3 * i], v[3 * i + 1], v[3 * i + 2]};
  exp_pow::Vec3<T> p =
      exp_pow::project_pow_row(x, alpha[i], is_dual[i] != 0, tol[i], max_iter);
  out[3 * i] = p.x;
  out[3 * i + 1] = p.y;
  out[3 * i + 2] = p.z;
}

template <typename T>
int launch_exp(const T* v, const uint8_t* d, const T* tol, T* out, int n, int max_iter,
               void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  exp_proj_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, d, tol, out, n, max_iter);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pow(const T* v, const T* alpha, const uint8_t* d, const T* tol, T* out, int n,
               int max_iter, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  pow_proj_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, alpha, d, tol, out, n, max_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries: v and out [n, 3] contiguous, is_dual [n] (0/1 bytes), tol and
// alpha [n]; the launch's cudaGetLastError() is returned.
extern "C" {

int exp_proj_f32(const float* v, const uint8_t* is_dual, const float* tol, float* out,
                 int n, int max_iter, void* stream) {
  return launch_exp(v, is_dual, tol, out, n, max_iter, stream);
}

int exp_proj_f64(const double* v, const uint8_t* is_dual, const double* tol, double* out,
                 int n, int max_iter, void* stream) {
  return launch_exp(v, is_dual, tol, out, n, max_iter, stream);
}

int pow_proj_f32(const float* v, const float* alpha, const uint8_t* is_dual,
                 const float* tol, float* out, int n, int max_iter, void* stream) {
  return launch_pow(v, alpha, is_dual, tol, out, n, max_iter, stream);
}

int pow_proj_f64(const double* v, const double* alpha, const uint8_t* is_dual,
                 const double* tol, double* out, int n, int max_iter, void* stream) {
  return launch_pow(v, alpha, is_dual, tol, out, n, max_iter, stream);
}

}  // extern "C"
