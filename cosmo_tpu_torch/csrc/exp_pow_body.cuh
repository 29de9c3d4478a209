// The arithmetic of the exponential- and power-cone projection kernels
// (exp_pow_proj.cu), written so that it also compiles as plain C++ on a
// host (EP_HD is empty there), where the tests run it beside the plain
// PyTorch version (cosmo_tpu_torch/ops/exp_pow.py).
//
// It is the lane function of cosmo_tpu/ops/exp_pow.py (_project_exp_one,
// :122, and _project_pow_one, :204), which the JAX package runs as one
// jax.vmap of nested lax.while_loop. The power cone's is one thread's
// plain loops (project_pow_row), each stopping at its own condition as a
// vmapped lane does. The exponential cone's is a step machine (below):
// its three nested loops flattened into one Newton step a call, with the
// transitions between them taken by a walk, so that the kernel can run a
// cone on several lanes and refill a lane as soon as its cone is done.
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
#if defined(EXP_POW_HOST_SQRT) && !defined(__CUDA_ARCH__)
// a host test's square roots (torch's on the CPU, which is the plain
// version's there and, unlike the card's, not always correctly rounded)
extern float (*host_sqrt32)(float);
extern double (*host_sqrt64)(double);
#endif
EP_HD float sqrt_(float a) {
#ifdef __CUDA_ARCH__
  return __fsqrt_rn(a);
#elif defined(EXP_POW_HOST_SQRT)
  return host_sqrt32(a);
#else
  return sqrtf(a);
#endif
}
EP_HD double sqrt_(double a) {
#ifdef __CUDA_ARCH__
  return __dsqrt_rn(a);
#elif defined(EXP_POW_HOST_SQRT)
  return host_sqrt64(a);
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

// ---- exponential cone: the step machine -------------------------------
// _project_exp_one (exp_pow.py:122) as a machine that a lane advances by
// one step of the inner Newton (_find_min_t, exp_pow.py:49) at a time, so
// that every lane of a warp runs the same step whatever its cone's phase.
// A cone (ExpCone) is the same in each of the L = 2^j - 1 lanes it runs
// on; each of those lanes evaluates g at one node (ExpNode) of the cone's
// round, rooted at the walk's node:
// * the bound search (exp_pow.py:91-101): nodes lam, 2 lam, ..., 2^(L-1)
//   lam, the next doublings;
// * the bisection (exp_pow.py:103-118): a heap of L nodes, the midpoint at
//   the root and under each node the next midpoint after g <= 0 (left:
//   u = node) and after g > 0 (right: l = node).
// g(lam) depends only on lam and the row (the Newton restarts from
// max(-t0, tol) every time), so these nodes' values are the serial loop's.
// The walk (exp_walk) then takes the serial loop's steps through the
// finished nodes, its stop tests included, on the sign of their g alone,
// and a new round starts where it leaves the round's nodes; a cone
// finishes with the last node it took.

// exp_in_cone(v, 0) and exp_in_dual(-v, 0) (exp_pow.py:31, :40) take
// the reference's _exp_safe of these; the classification (exp_case) takes
// both exps.
template <typename T> EP_HD T exp_clip(T t) { return clip(t, (T)-708.0, (T)708.0); }
template <typename T> EP_HD T exp_cone_arg(Vec3<T> v) {
  T ys = v.y > (T)0 ? v.y : (T)1;
  return exp_clip(dv(v.x, ys));
}
template <typename T> EP_HD T exp_dual_arg(Vec3<T> v) {
  T x = -v.x, y = -v.y;
  T xs = x < (T)0 ? x : (T)-1;
  return exp_clip(dv(y, xs));
}

// _project_exp_one's case of v: 1 in K_exp, 2 in the polar, 3 the closed
// form of x < 0, y < 0, 4 the bisection; e_cone and e_dual the exps of
// exp_cone_arg(v) and exp_dual_arg(v)
template <typename T> EP_HD int exp_case(Vec3<T> v, T e_cone, T e_dual) {
  bool interior = (v.y > (T)0) && (mul(v.y, e_cone) <= add(v.z, (T)0));
  bool boundary = (v.x <= (T)0) && (v.y == (T)0) && (v.z >= -(T)0);
  if (interior || boundary) return 1;
  T x = -v.x, y = -v.y, z = -v.z;
  bool c1 = (x < (T)0) && (sub(mul(-x, e_dual), mul(euler<T>(), z)) <= (T)0);
  bool c2 = (abs_(x) <= (T)0) && (y >= -(T)0) && (z >= -(T)0);
  if (c1 || c2) return 2;
  if (v.x < (T)0 && v.y < (T)0) return 3;
  return 4;
}

// the projection of a case 1-3 row
template <typename T> EP_HD Vec3<T> exp_closed_form(int c, Vec3<T> v) {
  if (c == 1) return v;
  if (c == 2) return Vec3<T>{(T)0, (T)0, (T)0};
  return Vec3<T>{v.x, mul((T)0, v.y), max_(v.z, (T)0)};
}

// (u + l) / 2 of the bisection: x * 0.5 is x / 2 in every bit (both are
// the one correctly rounded value of the same real number), without a
// division
EP_HD double half(double x) { return mul(x, 0.5); }

// the phases of a cone and the outcomes of a walk
enum : int { kExpIdle = 0, kExpBound = 1, kExpBisect = 2 };
enum : int { kExpWait = 0, kExpRestart = 1, kExpFinish = 2 };

template <typename T> struct ExpCone {
  T r0, s0, t0, tol;   // the row (negated for a dual cone) and its tolerance
  double l, u, lam;    // the bracket, and the lambda of the walk's node
  int phase;           // kExpIdle: no row
  int k;               // doublings taken (bound search), steps taken (bisection)
  int cur;             // the walk's node in this round
  int row;
  bool dual;
};

template <typename T> struct ExpNode {
  T lam_c, lam2, s0_lam;  // lam rounded to T, lam^2 in double rounded, s0 / lam
  T dt;                   // the Newton's iterate
  int steps;
  bool done;              // the Newton has ended
  bool up;                // then: g > 0
};

// a case-4 row (u: the row, negated for a dual cone): the bound search
// from lam = 0.125, l = 0
template <typename T>
EP_HD void exp_cone_start(ExpCone<T>& c, Vec3<T> u, T tol, bool dual, int row) {
  c.r0 = u.x;
  c.s0 = u.y;
  c.t0 = u.z;
  c.tol = tol;
  c.l = 0.0;
  c.u = 0.0;
  c.lam = 0.125;
  c.phase = kExpBound;
  c.k = 0;
  c.cur = 0;
  c.row = row;
  c.dual = dual;
}

// the lambda of node pos of a round rooted at the walk's node: in the
// bound search its pos-th doubling, in the bisection the heap's node
// (1-based index p: children 2p, left, and 2p + 1, right)
template <typename T> EP_HD double exp_node_lam(const ExpCone<T>& c, int pos) {
  if (c.phase == kExpBound) {
    double lam = c.lam;
    for (int i = 0; i < pos; ++i) lam = mul(lam, 2.0);
    return lam;
  }
  const int p = pos + 1;
  double lo = c.l, hi = c.u;
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    if ((p >> (b + 1)) == 0) continue;  // above the node's depth
    double m = half(add(hi, lo));
    if ((p >> b) & 1) lo = m;
    else hi = m;
  }
  return half(add(hi, lo));
}

// a node's Newton from its start (exp_pow.py:51)
template <typename T> EP_HD void exp_node_start(ExpNode<T>& n, const ExpCone<T>& c, double lam) {
  n.lam_c = (T)lam;
  n.lam2 = (T)mul(lam, lam);
  n.s0_lam = dv(c.s0, n.lam_c);
  n.dt = max_(-c.t0, c.tol);
  n.steps = 0;
  n.done = false;
  n.up = false;
}

// the argument of the log in a Newton step
template <typename T> EP_HD T exp_newton_arg(const ExpNode<T>& n) {
  return dv(max_(n.dt, tiny<T>()), n.lam_c);
}

// one step of _find_min_t (exp_pow.py:58-67), lg = log(exp_newton_arg(n));
// true where the step ends the node's Newton (its stop tests, or the 150th
// step)
template <typename T> EP_HD bool exp_newton_step(ExpNode<T>& n, T t0, T tol, T lg) {
  const T dt = n.dt;
  T dts = max_(dt, tiny<T>());
  T f = add(add(sub(dv(mul(dt, add(dt, t0)), n.lam2), n.s0_lam), lg), (T)1);
  T gf = add(dv(add(mul((T)2, dt), t0), n.lam2), dv((T)1, dts));
  T dtn = sub(dt, dv(f, gf));
  bool hit_low = dtn <= -t0;
  bool hit_zero = dtn <= (T)0;
  bool conv = abs_(f) < tol;
  n.dt = hit_low ? -t0 : (hit_zero ? (T)0 : dtn);
  n.steps += 1;
  return hit_low || hit_zero || conv || n.steps >= kNewtonSteps;
}

// _exp_grad_dual's minimizer (r, s, t) (exp_pow.py:75-77) at a node's dt
// (r0, t0: the cone's row)
template <typename T> EP_HD Vec3<T> exp_node_sol(T r0, T t0, T dt, T lam_c) {
  T t = add(dt, t0);
  T s = dv(mul(sub(t, t0), t), lam_c);
  T r = sub(r0, lam_c);
  return Vec3<T>{r, s, t};
}

// g's log argument and g (exp_pow.py:78-81), lg = log(exp_g_arg(p))
template <typename T> EP_HD T exp_g_arg(Vec3<T> p) {
  return dv(max_(p.y, tiny<T>()), max_(p.z, tiny<T>()));
}
template <typename T> EP_HD T exp_g(Vec3<T> p, T lg) {
  return p.y == (T)0 ? p.x : add(p.x, mul(p.y, lg));
}

// The serial loop's steps through the round's finished nodes (bit i of
// done: node i's Newton has ended; of up: its g > 0, false for a NaN as
// in the reference), as far as they reach: kExpWait at a node still
// running, kExpRestart where the walk leaves the round's L nodes (a new
// round's nodes start from the cone), kExpFinish where the bisection stops
// (c.cur: the node whose solution is the row's).
template <typename T>
EP_HD int exp_walk(ExpCone<T>& c, unsigned done, unsigned up, int L, int max_iter) {
  for (;;) {  // each step moves c.cur on, below L
    if (c.phase == kExpIdle || !((done >> c.cur) & 1u)) return kExpWait;
    const bool g_up = (up >> c.cur) & 1u;
    if (c.phase == kExpBound) {
      if (g_up && c.k < kBoundSteps) {
        c.l = c.lam;
        c.lam = mul(c.lam, 2.0);
        ++c.k;
        if (++c.cur == L) {
          c.cur = 0;
          return kExpRestart;
        }
      } else {
        c.u = c.lam;
        c.phase = kExpBisect;
        c.k = 0;
        c.cur = 0;
        c.lam = half(add(c.u, c.l));
        return kExpRestart;
      }
    } else {
      if (g_up) c.l = c.lam;
      else c.u = c.lam;
      ++c.k;
      // the reference's do-while: at least one step, then while u - l >= tol
      if (!((T)sub(c.u, c.l) >= c.tol && c.k < max_iter)) return kExpFinish;
      c.cur = 2 * c.cur + (g_up ? 2 : 1);
      c.lam = half(add(c.u, c.l));
      if (c.cur >= L) {
        c.cur = 0;
        return kExpRestart;
      }
    }
  }
}

// a row's output: the projection p of u = -v for a dual cone is v + p
template <typename T> EP_HD Vec3<T> exp_row_out(Vec3<T> u, bool dual, Vec3<T> p) {
  return dual ? Vec3<T>{add(-u.x, p.x), add(-u.y, p.y), add(-u.z, p.z)} : p;
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
EP_HD Vec3<T> project_pow_row(Vec3<T> v, T a, bool dual, T tol, int max_iter) {
  Vec3<T> u = dual ? Vec3<T>{-v.x, -v.y, -v.z} : v;
  Vec3<T> p = project_pow_one(u, a, tol, max_iter);
  return dual ? Vec3<T>{add(v.x, p.x), add(v.y, p.y), add(v.z, p.z)} : p;
}

}  // namespace exp_pow
