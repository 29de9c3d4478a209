// The per-cone body of the exponential- and power-cone projection kernel
// (exp_pow_proj.cu): everything one thread computes for one cone, written
// so that it also compiles as plain C++ on a host (EP_HD is empty there),
// where the tests run it beside the plain PyTorch version
// (cosmo_tpu_torch/ops/exp_pow.py).
//
// It is the lane function of cosmo_tpu/ops/exp_pow.py (_project_exp_one,
// :122, and _project_pow_one, :204), which the JAX package runs as one
// jax.vmap of nested lax.while_loop. Each loop here is a plain loop of one
// thread, so a cone stops at its own condition, as a vmapped lane does.
//
// Rounding follows the reference operation by operation:
// * products and sums are rounded one at a time (the __f*_rn / __d*_rn
//   intrinsics on the device keep nvcc from contracting them into FMAs);
// * the bisection variables l, u, lam are double in both types: they start
//   as Python floats, which JAX (x64 on) carries as float64; beside a
//   float32 value each is rounded to float32, and lam^2 is squared in
//   double first;
// * max(., 1e-300) is max(., 0) in float32; exp's clip at 708 overflows to
//   inf in float32 as in the reference;
// * max, min and clip return NaN when an argument is NaN, as XLA's do.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define EP_HD __host__ __device__ __forceinline__
#else
#define EP_HD inline
#endif

namespace exp_pow {

// ---- one rounding per operation -------------------------------------
EP_HD float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
EP_HD double mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
EP_HD float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
EP_HD double add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
EP_HD float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
EP_HD double sub(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}
EP_HD float dv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
EP_HD double dv(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}
EP_HD float sqrt_(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#else
  return sqrtf(a);
#endif
}
EP_HD double sqrt_(double a) {
#ifdef __CUDA_ARCH__
  return __dsqrt_rn(a);
#else
  return sqrt(a);
#endif
}
EP_HD float log_(float a) { return logf(a); }
EP_HD double log_(double a) { return log(a); }
EP_HD float exp_(float a) { return expf(a); }
EP_HD double exp_(double a) { return exp(a); }
EP_HD float pow_(float a, float b) { return powf(a, b); }
EP_HD double pow_(double a, double b) { return pow(a, b); }
EP_HD float abs_(float a) { return fabsf(a); }
EP_HD double abs_(double a) { return fabs(a); }

template <typename T> EP_HD bool isnan_(T a) { return a != a; }
// XLA's max / min: NaN if either argument is NaN
template <typename T> EP_HD T max_(T a, T b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (a > b ? a : b));
}
template <typename T> EP_HD T min_(T a, T b) {
  return isnan_(a) ? a : (isnan_(b) ? b : (a < b ? a : b));
}
template <typename T> EP_HD T clip(T x, T lo, T hi) { return min_(max_(x, lo), hi); }

// 1e-300 in T: 0 in float32
template <typename T> EP_HD T tiny();
template <> EP_HD float tiny<float>() { return 0.0f; }
template <> EP_HD double tiny<double>() { return 1e-300; }

// Euler's number rounded to T (jnp.e beside a T value)
template <typename T> EP_HD T euler() { return (T)2.718281828459045; }

// the reference's step limits (exp_pow.py:49, :91)
constexpr int kNewtonSteps = 150;
constexpr int kBoundSteps = 90;

template <typename T> struct Vec3 { T x, y, z; };

// ---- exponential cone -----------------------------------------------
template <typename T> EP_HD T exp_safe(T t) { return exp_(clip(t, (T)-708.0, (T)708.0)); }

// exp_in_cone(v, 0.0) (exp_pow.py:31)
template <typename T> EP_HD bool exp_in_cone0(T x, T y, T z) {
  T ys = y > (T)0 ? y : (T)1;
  bool interior = (y > (T)0) && (mul(y, exp_safe(dv(x, ys))) <= add(z, (T)0));
  bool boundary = (x <= (T)0) && (y == (T)0) && (z >= -(T)0);
  return interior || boundary;
}

// exp_in_dual(v, 0.0) (exp_pow.py:40)
template <typename T> EP_HD bool exp_in_dual0(T x, T y, T z) {
  T xs = x < (T)0 ? x : (T)-1;
  bool c1 = (x < (T)0) && (sub(mul(-x, exp_safe(dv(y, xs))), mul(euler<T>(), z)) <= (T)0);
  bool c2 = (abs_(x) <= (T)0) && (y >= -(T)0) && (z >= -(T)0);
  return c1 || c2;
}

// _find_min_t (exp_pow.py:49): the inner Newton for t* given lambda
template <typename T> EP_HD T find_min_t(double lam, T s0, T t0, T tol) {
  const T lam_c = (T)lam;
  const T lam2 = (T)mul(lam, lam);
  T dt = max_(-t0, tol);
  bool done = false;
  for (int k = 0; k < kNewtonSteps && !done; ++k) {
    T dts = max_(dt, tiny<T>());
    T f = add(add(sub(dv(mul(dt, add(dt, t0)), lam2), dv(s0, lam_c)),
                  log_(dv(dts, lam_c))), (T)1);
    T gf = add(dv(add(mul((T)2, dt), t0), lam2), dv((T)1, dts));
    T dtn = sub(dt, dv(f, gf));
    bool hit_low = dtn <= -t0;
    bool hit_zero = dtn <= (T)0;
    bool conv = abs_(f) < tol;
    dt = hit_low ? -t0 : (hit_zero ? (T)0 : dtn);
    done = hit_low || hit_zero || conv;
  }
  return add(dt, t0);
}

// _exp_grad_dual (exp_pow.py:73): g(lambda) and its minimizer (r, s, t)
template <typename T>
EP_HD T exp_grad_dual(double lam, T r0, T s0, T t0, T tol, Vec3<T>* sol) {
  const T lam_c = (T)lam;
  T t = find_min_t(lam, s0, t0, tol);
  T s = dv(mul(sub(t, t0), t), lam_c);
  T r = sub(r0, lam_c);
  T g = s == (T)0 ? r
                  : add(r, mul(s, log_(dv(max_(s, tiny<T>()), max_(t, tiny<T>())))));
  sol->x = r;
  sol->y = s;
  sol->z = t;
  return g;
}

// _project_exp_case4 (exp_pow.py:85): the bound search, one bisection
// step, then the bisection while u - l >= tol
template <typename T>
EP_HD Vec3<T> exp_case4(T r0, T s0, T t0, T tol, int max_iter) {
  Vec3<T> sol;
  double l = 0.0, lam = 0.125;
  T g = exp_grad_dual(lam, r0, s0, t0, tol, &sol);
  for (int k = 0; g > (T)0 && k < kBoundSteps; ++k) {
    l = lam;
    lam = mul(lam, 2.0);
    g = exp_grad_dual(lam, r0, s0, t0, tol, &sol);
  }
  double u = lam;
  int k = 0;
  do {
    lam = dv(add(u, l), 2.0);
    g = exp_grad_dual(lam, r0, s0, t0, tol, &sol);
    if (g > (T)0) l = lam;
    else u = lam;
    ++k;
  } while ((T)sub(u, l) >= tol && k < max_iter);
  return sol;
}

// _project_exp_one (exp_pow.py:122)
template <typename T> EP_HD Vec3<T> project_exp_one(Vec3<T> v, T tol, int max_iter) {
  if (exp_in_cone0(v.x, v.y, v.z)) return v;
  if (exp_in_dual0(-v.x, -v.y, -v.z)) return Vec3<T>{(T)0, (T)0, (T)0};
  if (v.x < (T)0 && v.y < (T)0) return Vec3<T>{v.x, mul((T)0, v.y), max_(v.z, (T)0)};
  return exp_case4(v.x, v.y, v.z, tol, max_iter);
}

// ---- power cone -----------------------------------------------------
// pow_in_cone(v, a, 0.0) (exp_pow.py:150)
template <typename T> EP_HD bool pow_in_cone0(T x, T y, T z, T a) {
  T xp = max_(x, (T)0), yp = max_(y, (T)0);
  return (x >= (T)0) && (y >= (T)0) &&
         (mul(pow_(xp, a), pow_(yp, sub((T)1, a))) >= sub(abs_(z), (T)0));
}

// pow_in_dual(v, a, 0.0) (exp_pow.py:157)
template <typename T> EP_HD bool pow_in_dual0(T s, T t, T w, T a) {
  T sp = max_(s, (T)0), tp = max_(t, (T)0);
  T b = sub((T)1, a);
  T lhs = mul(pow_(sp, a), pow_(tp, b));
  T rhs = sub(mul(mul(abs_(w), pow_(a, a)), pow_(b, b)), (T)0);
  return (s >= -(T)0) && (t >= -(T)0) && (lhs >= rhs);
}

// _phic (exp_pow.py:167)
template <typename T> EP_HD T phic(T x0, T z0, T r, T a) {
  T inner = add(mul(x0, x0), mul(mul(mul((T)4, a), r), sub(abs_(z0), r)));
  return max_(mul((T)0.5, add(x0, sqrt_(inner))), (T)1e-10);
}

// _project_pow_case4 (exp_pow.py:171): Newton on r, then (px, py) at the
// final r
template <typename T> EP_HD Vec3<T> pow_case4(T x0, T y0, T z0, T a, T tol, int max_iter) {
  const T b = sub((T)1, a);
  const T az0 = abs_(z0);
  T r = dv(az0, (T)2);
  bool done = false;
  for (int k = 0; k < max_iter && !done; ++k) {
    T px = phic(x0, z0, r, a);
    T py = phic(y0, z0, r, b);
    T pab = mul(pow_(px, a), pow_(py, b));
    T phi = sub(pab, r);
    bool conv = abs_(phi) < tol;
    T d = sub(az0, mul((T)2, r));
    T dpx = mul(dv(a, sub(mul((T)2, px), x0)), d);
    T dpy = mul(dv(b, sub(mul((T)2, py), y0)), d);
    T dphi = sub(mul(pab, add(dv(mul(a, dpx), px), dv(mul(b, dpy), py))), (T)1);
    T r_new = clip(sub(r, dv(phi, dphi)), (T)0, az0);
    if (!conv) r = r_new;
    done = conv;
  }
  Vec3<T> out;
  out.x = phic(x0, z0, r, a);
  out.y = phic(y0, z0, r, b);
  out.z = dv(mul(z0, r), max_(az0, tiny<T>()));
  return out;
}

// _project_pow_one (exp_pow.py:204)
template <typename T> EP_HD Vec3<T> project_pow_one(Vec3<T> v, T a, T tol, int max_iter) {
  if (pow_in_cone0(v.x, v.y, v.z, a)) return v;
  if (pow_in_dual0(-v.x, -v.y, -v.z, a)) return Vec3<T>{(T)0, (T)0, (T)0};
  if (abs_(v.z) <= tol) return Vec3<T>{max_(v.x, (T)0), max_(v.y, (T)0), v.z};
  return pow_case4(v.x, v.y, v.z, a, tol, max_iter);
}

// ---- one cone, primal or dual (Moreau: Pi_K*(v) = v + Pi_K(-v)) -------
template <typename T>
EP_HD Vec3<T> project_exp_row(Vec3<T> v, bool dual, T tol, int max_iter) {
  Vec3<T> u = dual ? Vec3<T>{-v.x, -v.y, -v.z} : v;
  Vec3<T> p = project_exp_one(u, tol, max_iter);
  return dual ? Vec3<T>{add(v.x, p.x), add(v.y, p.y), add(v.z, p.z)} : p;
}

template <typename T>
EP_HD Vec3<T> project_pow_row(Vec3<T> v, T a, bool dual, T tol, int max_iter) {
  Vec3<T> u = dual ? Vec3<T>{-v.x, -v.y, -v.z} : v;
  Vec3<T> p = project_pow_one(u, a, tol, max_iter);
  return dual ? Vec3<T>{add(v.x, p.x), add(v.y, p.y), add(v.z, p.z)} : p;
}

}  // namespace exp_pow
