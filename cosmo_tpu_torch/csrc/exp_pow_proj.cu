// Exponential- and power-cone projection on Hopper.
//
// Replaces the JAX package's one jax.vmap of nested lax.while_loop over
// every cone of a family (cosmo_tpu/ops/exp_pow.py:133 project_exp, :213
// project_pow), which XLA runs as a loop on the device with a predicate a
// lane. Not a TPU kernel (the JAX package has no Pallas kernel for it): a
// PyTorch version of those loops needs a host read a step, or up to ~28,500
// masked Newton steps of ~15 launches each, for every ADMM iteration.
//
// What bounds it on an H100: not bytes (65,122 cones in float64 are 1.6 MB
// in and out, 0.5 us at 3.35 TB/s) but chains of dependent operations: an
// exp cone in case 4 runs a bound search of up to 90 doublings and a
// bisection of up to max_iter steps, each around an inner Newton of up to
// 150 steps with a log and divisions, every one rounded as the plain
// version rounds it (no FMA). One thread a cone left most lanes of a warp
// idle: cones in cases 1-3 leave at once, lanes in the bound search, the
// bisection and the Newton diverge, and a warp lasted as long as its
// slowest cone; on the logistic path a fifth of the cones take ~20 times
// the median's Newton steps, so the slowest cones' chains set the time.
//
// The exp kernel (exp_proj_kernel), one launch, persistent blocks of 8
// warps (as many as the card holds, from the occupancy API):
// * splits by case first: a warp takes as many rows as its idle cones lack
//   from a row cursor (one atomicAdd), classifies them one a lane, writes
//   rows in cases 1-3 at once and appends the case-4 rows to its queue in
//   shared memory (__ballot_sync / __popc);
// * runs one Newton step a pass: a lane holds one node of a cone's step
//   machine (exp_pow_body.cuh), so every lane of the warp runs the same
//   step whatever its cone's phase; a walk over the nodes' signs (two
//   ballots) takes the transitions where the node it waits on has ended,
//   once half the warp's cones wait on one or one has waited kWalkWait
//   passes (a walk costs a good part of a Newton step);
// * refills lanes: a cone that is done writes its row and its lanes take
//   the next case-4 row from the queue;
// * evaluates ahead: a cone runs on kLanes = 3 lanes, which evaluate g at
//   its next 3 doublings, or at the bisection's midpoint and both of the
//   next quarter points (two steps a round), at once; the walk keeps the
//   serial loop's steps, so each row gets the plain version's bits;
// * compacts: every kWindow passes, once a block's rows are all taken, its
//   live cones move (whole lane states, through shared memory) to its
//   first warps, and the warps they leave stop issuing, so the slowest
//   cones, which set the time on the logistic path, run in few warps.
// The cone's state lives in shared memory (the Newton step keeps its node,
// t0, tol and r0 in registers), which keeps a float64 lane within 80
// registers. The power cone (pow_proj_kernel) stays one thread a cone: its
// rows (l1.5 regression's 32,561, phase 3's 65,122) fit in one wave of the
// card, each warp's time is its longest Newton chain, and a persistent
// form with case-4 rows queued and refilled into lanes was 1-5% slower on
// them (PERF.md, the pow kernel).
//
// The row cursor and the count of warps that have left live in one of
// kSlots static pairs, taken in turn by each launch; the last warp to
// leave sets its pair back to 0. Launches on other streams at the same
// time take other pairs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "exp_pow_body.cuh"

namespace {

constexpr int kThreads = 128;     // the pow kernel's block
constexpr int kExpThreads = 256;  // the exp kernel's block
constexpr int kExpWarps = kExpThreads / 32;
// lanes a case-4 cone runs on: 2^j - 1, the bisection taking j steps a
// round (1, 3 and 7 measured with profile_exp.py --lanes: PERF.md)
constexpr int kLanes = 3;
constexpr int kCones = 32 / kLanes;  // a warp's cones (lanes 30 and 31 idle)
static_assert((kLanes & (kLanes + 1)) == 0 && kLanes <= 31,
              "a cone runs on 2^j - 1 lanes of a warp");
constexpr int kQueue = 32;        // a warp's queue: at most the rows its cones lack
constexpr int kWindow = 32;       // passes between the exp kernel's block barriers
constexpr int kWalkWait = 4;      // passes an ended node waits at most for its walk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 64;

__device__ unsigned int exp_cursor[kSlots][2];
std::atomic<unsigned> next_slot{0};

#ifdef EXP_PROJ_PROFILE
// warp passes and lane Newton steps, summed over the launches since the
// last exp_proj_profile()
__device__ unsigned long long exp_profile_counts[2];
#endif

template <typename T>
__device__ __forceinline__ exp_pow::Vec3<T> load_row(const T* v, int i) {
  const size_t o = 3 * static_cast<size_t>(i);
  return exp_pow::Vec3<T>{v[o], v[o + 1], v[o + 2]};
}

template <typename T>
__device__ __forceinline__ void store_row(T* out, int i, exp_pow::Vec3<T> p) {
  const size_t o = 3 * static_cast<size_t>(i);
  out[o] = p.x;
  out[o + 1] = p.y;
  out[o + 2] = p.z;
}

template <typename T>
__device__ __forceinline__ exp_pow::Vec3<T> negated(exp_pow::Vec3<T> x, bool dual) {
  return dual ? exp_pow::Vec3<T>{-x.x, -x.y, -x.z} : x;
}

// blocks of the exp kernel an SM must hold: float64 up to 80 registers a
// thread (the loop state and a Newton step's temporaries without a spill)
template <typename T> constexpr int exp_min_blocks() { return sizeof(T) == 8 ? 3 : 4; }

template <typename T>
__global__ void __launch_bounds__(kExpThreads, exp_min_blocks<T>())
exp_proj_kernel(const T* __restrict__ v, const uint8_t* __restrict__ is_dual,
                const T* __restrict__ tol, T* __restrict__ out, int n, int max_iter,
                unsigned int* __restrict__ cursor) {
  using namespace exp_pow;
  // each lane's cone (the same in each of its lanes) lives in shared
  // memory: the Newton step keeps only its node, t0, tol and r0 in
  // registers, the walk reads and writes the rest where it lies
  __shared__ ExpCone<T> cones[kExpThreads];
  __shared__ ExpNode<T> moved_node[kExpThreads];
  __shared__ short moved_from[kExpThreads];
  __shared__ int queue[kExpWarps][kQueue];
  __shared__ int live[kExpWarps], queued[kExpWarps];
  __shared__ bool rows_left;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* q = queue[w];
  ExpCone<T>& c = cones[threadIdx.x];
  const unsigned below = (1u << lane) - 1u;
  // the lane's node and its cone's first lane
  const int pos = lane % kLanes, base = lane - pos;
  const bool leader = pos == 0 && lane < kCones * kLanes;
  int count = 0;          // rows in the warp's queue
  bool drained = false;   // the cursor has passed the last row
  bool idle = false;      // no cone, no row: the warp waits for the window's end
  bool moved = false;     // cones moved here: walk once
  bool active = false;    // the lane's cone has a row
  int quiet = 0;          // passes since the warp's last walk
  bool pending = false;   // the node the lane's walk waits on has ended
  T r0 = 0, t0 = 0, tl = 0;
  ExpNode<T> nd{};
  c.phase = kExpIdle;
#ifdef EXP_PROJ_PROFILE
  unsigned long long passes = 0, steps = 0;
#endif
  for (;;) {
    for (int pass = 0; pass < kWindow && !idle; ++pass) {
      // one Newton step of the lane's node; the sign of g where it ends
      if (active && !nd.done) {
        if (exp_newton_step(nd, t0, tl, log_(exp_newton_arg(nd)))) {
          const Vec3<T> p = exp_node_sol(r0, t0, nd.dt, nd.lam_c);
          nd.up = exp_g(p, log_(exp_g_arg(p))) > (T)0;
          nd.done = true;
          pending = pending || pos == c.cur;
        }
#ifdef EXP_PROJ_PROFILE
        ++steps;
#endif
      }
#ifdef EXP_PROJ_PROFILE
      ++passes;
#endif
      // the walk can move only where the node it waits on has ended: it
      // runs once half the warp's cones wait, or one has waited kWalkWait
      // passes, or a cone needs a row, or cones moved here
      const bool more = !(drained && count == 0);
      const unsigned waits = __ballot_sync(kFull, pending);
      if (!(__any_sync(kFull, moved || (leader && more && !active)) ||
            2 * __popc(waits) >= kCones || (waits && quiet >= kWalkWait))) {
        // a node ends within kNewtonSteps steps: a warp with a cone that
        // has gone longer without a walk would wait for ever
        if (++quiet > kNewtonSteps + 1 && __any_sync(kFull, active)) __trap();
        continue;
      }
      moved = false;
      pending = false;
      quiet = 0;

      // the walk, alike in each lane of a cone, over its nodes' signs
      const unsigned done = __ballot_sync(kFull, nd.done) >> base;
      const unsigned up = __ballot_sync(kFull, nd.done && nd.up) >> base;
      const int step = exp_walk(c, done, up, kLanes, max_iter);
      if (__any_sync(kFull, step == kExpFinish)) {
        const T dt = __shfl_sync(kFull, nd.dt, base + c.cur);
        const T lam_c = __shfl_sync(kFull, nd.lam_c, base + c.cur);
        if (step == kExpFinish) {
          if (pos == 0)
            store_row(out, c.row, exp_row_out(Vec3<T>{c.r0, c.s0, c.t0}, c.dual,
                                              exp_node_sol(c.r0, c.t0, dt, lam_c)));
          c.phase = kExpIdle;
          active = false;
        }
      }
      if (step == kExpRestart) exp_node_start(nd, c, exp_node_lam(c, pos));
      if (!__any_sync(kFull, leader && more && !active)) {
        idle = !more && __all_sync(kFull, !active);
        continue;
      }

      // idle cones take rows from the queue, which takes as many rows from
      // the cursor as they lack (rows a warp does not need stay there for
      // the others) while it holds fewer than they need
      const unsigned need = __ballot_sync(kFull, leader && !active);
      const int want = __popc(need);
      while (want > count && !drained) {
        const int take = want - count;
        int first = 0;
        if (lane == 0) first = static_cast<int>(atomicAdd(cursor, static_cast<unsigned>(take)));
        first = __shfl_sync(kFull, first, 0);
        drained = first >= n - take;
        const int i = first + lane;
        bool queued_row = false;
        if (lane < take && i < n) {
          const bool d = is_dual[i] != 0;
          const Vec3<T> u = negated(load_row(v, i), d);
          const int cs = exp_case(u, exp_(exp_cone_arg(u)), exp_(exp_dual_arg(u)));
          if (cs < 4) store_row(out, i, exp_row_out(u, d, exp_closed_form(cs, u)));
          queued_row = cs == 4;
        }
        const unsigned m = __ballot_sync(kFull, queued_row);
        if (queued_row) q[count + __popc(m & below)] = i;
        count += __popc(m);
        __syncwarp();
      }
      int row = -1;
      if ((need >> lane) & 1u) {
        const int r = __popc(need & below);
        if (r < count) row = q[count - 1 - r];
      }
      __syncwarp();
      count -= min(want, count);
      row = __shfl_sync(kFull, row, base);
      if (row >= 0 && lane < kCones * kLanes) {
        const bool d = is_dual[row] != 0;
        exp_cone_start(c, negated(load_row(v, row), d), tol[row], d, row);
        exp_node_start(nd, c, exp_node_lam(c, pos));
        r0 = c.r0;
        t0 = c.t0;
        tl = c.tol;
        active = true;
      }
      idle = drained && count == 0 && __all_sync(kFull, !active);
    }

    // the window's end: once no row is left for the block, its live cones
    // move, whole lane states, to its first warps where they fill fewer
    // warps, and the warps they leave wait; the block ends with its last
    // cone
    const unsigned lives = __ballot_sync(kFull, leader && active);
    if (lane == 0) {
      live[w] = __popc(lives);
      queued[w] = count;
    }
    if (threadIdx.x == 0)
      rows_left = *reinterpret_cast<volatile unsigned int*>(cursor) < static_cast<unsigned>(n);
    __syncthreads();
    int total = 0, before = 0, occupied = 0;
    bool waiting = rows_left;
#pragma unroll
    for (int i = 0; i < kExpWarps; ++i) {
      total += live[i];
      before += i < w ? live[i] : 0;
      occupied += live[i] > 0;
      waiting = waiting || queued[i] > 0;
    }
    __syncthreads();
    if (!waiting && total == 0) break;
    if (!waiting && (total + kCones - 1) / kCones < occupied) {
      // a lane's state goes to the same lane of its cone's new place
      if (active) {
        const int at = (before + __popc(lives & ((1u << base) - 1u))) * kLanes + pos;
        moved_node[at] = nd;
        moved_from[at] = static_cast<short>(threadIdx.x);
      }
      __syncthreads();
      const int at = (w * kCones + lane / kLanes) * kLanes + pos;
      active = lane < kCones * kLanes && at < total * kLanes;
      // the state this lane takes, read before any lane writes its own
      ExpCone<T> to{};
      to.phase = kExpIdle;
      nd = ExpNode<T>{};
      if (active) {
        to = cones[moved_from[at]];
        nd = moved_node[at];
      }
      __syncthreads();
      c = to;
      r0 = c.r0;
      t0 = c.t0;
      tl = c.tol;
      drained = true;
      moved = true;
      idle = __all_sync(kFull, !active);
    }
  }
#ifdef EXP_PROJ_PROFILE
  if (lane == 0) atomicAdd(&exp_profile_counts[0], passes);
  atomicAdd(&exp_profile_counts[1], steps);
#endif
  // the last warp out sets the launch's pair back to 0
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(cursor + 1, 1u) == gridDim.x * kExpWarps - 1) {
      __threadfence();
      atomicExch(cursor, 0u);
      atomicExch(cursor + 1, 0u);
    }
  }
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

// blocks of the exp kernel for n rows: one warp for each kCones rows (the
// most that can be in case 4), at most as many as the card holds at once
template <typename T>
int exp_blocks(int n, int* blocks) {
  static int resident[64];  // a device's blocks at once, 0 until asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int& full = resident[dev & 63];
  if (full == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exp_proj_kernel<T>,
                                                        kExpThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    full = sms * per_sm;
  }
  const long long warps = (static_cast<long long>(n) + kCones - 1) / kCones;
  *blocks = static_cast<int>(std::min<long long>((warps + kExpWarps - 1) / kExpWarps, full));
  return 0;
}

template <typename T>
int launch_exp(const T* v, const uint8_t* d, const T* tol, T* out, int n, int max_iter,
               void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  int err = exp_blocks<T>(n, &blocks);
  if (err != 0) return err;
  unsigned int* pairs = nullptr;
  cudaError_t e = cudaGetSymbolAddress(reinterpret_cast<void**>(&pairs), exp_cursor);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned int* pair = pairs + 2 * (next_slot.fetch_add(1) % kSlots);
  exp_proj_kernel<T><<<blocks, kExpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, d, tol, out, n, max_iter, pair);
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

#ifdef EXP_PROJ_PROFILE
// the exp kernel's warp passes and lane Newton steps since the last call
// (synchronises the device), into out[0..1]; the counts start again at 0
int exp_proj_profile(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, exp_profile_counts, 2 * sizeof(*out));
  const unsigned long long zero[2] = {0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(exp_profile_counts, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif

}  // extern "C"
