// The plain version's rounding for the Jacobi kernels of the large sides
// (jacobi_eig_large.cu, jacobi_eig_cluster.cu): each product, sum, quotient
// and square root rounded once, as the plain version's torch operations
// round it (__f*_rn / __d*_rn: no FMA contraction, IEEE division and square
// root), so that a kernel gives the plain version's bits; and the rotation
// of eigh.rotation_angles with its guards.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace jacobi {
namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T> struct Tiny16;
template <> struct Tiny16<float> { static constexpr float value = FLT_MIN * 16.0f; };
template <> struct Tiny16<double> { static constexpr double value = DBL_MIN * 16.0; };

// (c, s) of the rotation that zeroes a_pq, as eigh.rotation_angles computes
// it: tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau) / (|tau| + sqrt(tau^2 +
// 1)) (sign(0) = 0), t = 1 when tau == 0, c = 1 / sqrt(t^2 + 1), s = t c;
// the identity rotation when |a_pq| <= 16 tiny
template <typename T>
__device__ __forceinline__ void rotation_rn(T app, T aqq, T apq, T& c, T& s) {
  const bool small = fabs(apq) <= Tiny16<T>::value;
  const T tau = div_rn(sub_rn(aqq, app), mul_rn(T(2), small ? T(1) : apq));
  const T sign = static_cast<T>((T(0) < tau) - (tau < T(0)));
  T t = div_rn(sign, add_rn(fabs(tau), sqrt_rn(add_rn(mul_rn(tau, tau), T(1)))));
  if (tau == T(0)) t = T(1);
  const T c0 = div_rn(T(1), sqrt_rn(add_rn(mul_rn(t, t), T(1))));
  c = small ? T(1) : c0;
  s = small ? T(0) : mul_rn(t, c0);
}

// the new p and q of a pair (x_p, x_q) turned by (c, s): c x_p - s x_q and
// s x_p + c x_q
template <typename T>
__device__ __forceinline__ T turn_p(T c, T s, T xp, T xq) {
  return sub_rn(mul_rn(c, xp), mul_rn(s, xq));
}
template <typename T>
__device__ __forceinline__ T turn_q(T c, T s, T xp, T xq) {
  return add_rn(mul_rn(s, xp), mul_rn(c, xq));
}

}  // namespace
}  // namespace jacobi
