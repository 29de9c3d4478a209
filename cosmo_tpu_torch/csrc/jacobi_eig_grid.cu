// Warm-started eigendecomposition of symmetric matrices of the large sides by
// cyclic Jacobi over the round-robin rounds, for NVIDIA Hopper (built for
// sm_90a): one cooperative grid of CTAs a matrix, W in the grid's shared
// memory for the whole call, the CTAs exchanging through global memory and
// per-CTA round flags, and V replayed afterwards from a log of the rounds'
// angles.
//
// Replaces, as jacobi_eig_cluster.cu and jacobi_eig_large.cu do, the XLA loop
// of cosmo_tpu/ops/eigh.py::psd_project_amortized (jacobi_eigh(W, sweeps,
// "vec", V0=V_prev), a lax.fori_loop whose trip count is a traced scalar); it
// is not a TPU kernel. The function is that of ops/eigh.jacobi_eig_plain
// before its reconstruction: from V0, `full` sweeps when the device byte
// *stale is set, else `warm`, the count read on the card; each sweep the
// k - 1 rounds of _round_robin_rounds(k) (the circle method), a round's k/2
// angles from the round-start a_pp, a_qq, a_pq (eigh.rotation_angles, its
// guards), then the rows p, q of W, then the columns p, q of W and of V;
// W <- (W + W^T) / 2 after each sweep; out d = diag W and V. Every operation
// is rounded as the plain version rounds it (jacobi_rn.cuh), so the kernel
// gives the plain version's bits. The wrapper (ops/jacobi_eig.py) forms
// P = V max(d, 0) V^T as a batched torch product (eigh.sym_reconstruct).
// ops/jacobi_eig.kernel_for sends a side here when a cluster's shared memory
// does not hold W and the grid's does (grid_smem_bytes); past that,
// jacobi_eig_large.cu keeps W and V in global memory.
//
// Design.
//   * Ownership by column slot, as in jacobi_eig_cluster.cu (the geometry of
//     jacobi_circle.cuh): G CTAs a matrix (ops/jacobi_eig.grid_ctas: 128,
//     at most k/2), CTA g owns the slots
//     [g h / G, (g+1) h / G) and all k rows of their columns, its tops and
//     its bottoms each an arc of a ring in its shared memory; each round it
//     turns its tiles {p_i, q_i} x {p_j, q_j} (every pair i, its slots j) in
//     place. All of W is 4.7 MB at [1, 768] float64, of the grid's ~30 MB.
//   * What crosses between CTAs goes through global memory, double-buffered
//     by the round's parity: the column that leaves an arc for the next CTA
//     (one a round each way, into that CTA's inbox, which it copies into its
//     ring's spare column with cp.async at the next round's start), and each
//     CTA's mailbox: for each of its columns, the two entries the next
//     round's angle reads (its diagonal entry and its entry at its next
//     partner's row). The boundary slots' tiles write their leaving rows
//     and mailbox entries to global memory as they turn them; the other
//     slots' entries are computed from the round-start columns (peek_tile)
//     beside them. Every CTA computes all k/2 angles of a round from the
//     mailboxes (the same inputs and code give every CTA the same bits); the
//     owner of a slot logs its (c, s).
//   * Per-CTA round flags in place of a grid barrier. A CTA publishes its
//     flag (a fence, then the round's number) once its mailbox and leaving
//     rows are written, then turns its other tiles while the others read.
//     A round's angles need every CTA's mailbox, so a CTA waits for every
//     flag of its matrix to reach the round (one warp polls them, each in an
//     L2 line of its own): a split barrier whose wait comes one tile pass
//     after its arrival. Reuse of a parity buffer is safe: a CTA writes the
//     buffer of round t + 1 after it saw every flag reach t, that is after
//     every CTA had read the buffer's round t - 1 contents.
//   * The symmetrisation. At a sweep's end each CTA writes its columns into
//     a row-major copy of W in global memory before it publishes the round;
//     at the next round's start it reads row b of that copy for its column
//     b and stores 0.5 (W[a, b] + W[b, a]) (the plain version's rounding; the
//     sum commutes, so both owners of a pair of entries get the same bits).
//     The angle inputs of that round become 0.5 (x + x) and 0.5 (a_pq + a_qp).
//   * V leaves the chain. Row i of V turns only by the round's (c, s) at the
//     columns p, q of row i. A CTA's last three warps replay the angle log
//     on its k / G rows of V in its shared memory while its other twelve run
//     the W phase: a round once the W phase's wait has seen every CTA
//     publish the next (so every CTA has logged it), a named barrier of
//     their own a round. The arithmetic per entry is the plain version's, so
//     the bits are.
//   * Launch: cudaLaunchCooperativeKernel, so that every CTA is resident and
//     the spinning waits cannot deadlock; one CTA an SM (480 threads, so
//     that a thread may keep 136 registers). A wait that outlasts kWaitNs
//     (a CTA that never publishes: a fault) ends the launch with __trap(),
//     so that the stream's next synchronisation raises instead of the
//     call returning outputs that are not the function's.
//
// What bounds it. The function's work (chip_smoke.eig_bound_ms) bounds it by
// operations, ~0.15 ms for [1, 640] float64 at 2 sweeps. The kernel is a
// chain of sweeps x (k - 1) rounds, each (profile_grid.py, an H100, [1, 640]
// and [1, 768] float64): the flags' round trip through L2 (a fence, a store,
// the polls; the CTAs publish over ~1 us and a CTA sees the last flag ~1.3
// us after it is stored; the other tiles and the next round's plans inside
// the wait), the angles (the mailboxes' loads, then IEEE divisions and square
// roots in a dependent chain; ~1.0 us), the boundary slots' tiles before
// the flag (~1.0-1.3 us) and the flag's fence (~0.5 us): ~4.7-5.0 us a
// round, ~40 times the function's operations. The replay of V costs nothing
// on top. Not used: wgmma (a round's rotations as a product would round
// otherwise), TMA tensor maps (W is read once).
//
// C interface (in the library of jacobi_proj.cu, loaded with ctypes):
// jacobi_eig_grid_f32 / jacobi_eig_grid_f64 launch on the given stream and
// return the launch's error or cudaGetLastError() as an int;
// cudaErrorInvalidValue for k odd or < 2, B <= 0, warm or full < 0, a CTA
// count outside 1..k/2, W that does not fit a CTA's shared memory, or a null
// pointer other than n_full. `w` and `v0` are [B, k, k] inputs, `d` [B, k]
// and `v` [B, k, k] outputs; `scratch` holds jacobi_eig_grid_scratch(k, G,
// log_rounds) entries of T; `flags` jacobi_eig_grid_flag_ints(G) int32 set
// to 0 (a CTA's round flag each); `stale` a device byte; `n_full` a device int that counts full-sweep
// launches (or null). jacobi_eig_grid_scratch_f32 / _f64 (k, ctas,
// log_rounds) return that count, jacobi_eig_grid_smem_f32 / _f64 (k, ctas)
// a CTA's shared memory.

#include <cuda_runtime.h>

#include "jacobi_circle.cuh"

namespace jacobi {
namespace {

// a CTA's threads: the W phase's warps, then the V replay's
constexpr int kWThreads = 384;
constexpr int kReplayThreads = 96;
constexpr int kGridThreads = kWThreads + kReplayThreads;
constexpr int kGridSmemMax = 232448;  // bytes a block may use on sm_90
// the longest a wait may take (a build with -DJACOBI_GRID_WAIT_NS=0 gives up
// at the first wait that finds a flag behind: the test of the trap)
#ifndef JACOBI_GRID_WAIT_NS
#define JACOBI_GRID_WAIT_NS 4000000000ull
#endif
constexpr unsigned long long kWaitNs = JACOBI_GRID_WAIT_NS;
// a CTA's round flag every 32 ints (128 bytes), each in an L2 line of its
// own
constexpr int kFlagStride = 32;
constexpr int kReplayUnroll = 4;  // rows of V a replay thread turns at once

// a column's two mailbox entries, loaded at once
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<double> { using type = double2; };

__host__ __device__ __forceinline__ long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// The layout of a CTA's shared memory and of the scratch in global memory,
// for side k and G CTAs a matrix. Shared: the columns (2 (M + 1), each of
// column_stride entries: the tops ring, then the bottoms ring; CTA 0 keeps
// slot 0's fixed top in its tops ring's last column); the CTA's rows of V
// (ceil(k / G) of k entries); the angles [h][2]; the pairs [2][h] (p | q <<
// 16; a round's, the next's); the slot plans [2][M] and their rings [M];
// a word: the rounds whose log is complete (in 32 bytes).
// Global: the angle log [log_rounds][log_stride], the mailboxes [2][h][2][2],
// the inboxes [2][G][2][ks], the row-major copy of W [k][k].
template <typename T>
struct GridLayout {
  int h, M, ks, log_stride, rows;
  long long vrows, angles, pairs, plans, rings, words, smem;
  long long mail, inbox, dump, scratch;  // entries of T
};

template <typename T>
__host__ __device__ GridLayout<T> grid_layout(int k, int G, long long log_rounds) {
  GridLayout<T> L;
  const long long s = static_cast<long long>(sizeof(T));
  L.h = k / 2;
  L.M = ceil_div(L.h, G);
  L.ks = column_stride<T>(k);
  L.log_stride = column_stride<T>(2 * L.h);
  L.rows = ceil_div(k, G);
  L.vrows = 2LL * (L.M + 1) * L.ks * s;
  L.angles = L.vrows + round16(static_cast<long long>(L.rows) * k * s);
  L.pairs = L.angles + round16(2LL * L.h * s);
  L.plans = L.pairs + round16(8LL * L.h);
  L.rings = L.plans + round16(8LL * kSlotInts * L.M);
  L.words = L.rings + round16(static_cast<long long>(sizeof(SlotRings)) * L.M);
  L.smem = L.words + 32;
  L.mail = log_rounds * L.log_stride;
  L.inbox = L.mail + 8LL * L.h;
  L.dump = L.inbox + 4LL * G * L.ks;
  L.scratch = L.dump + static_cast<long long>(k) * k;
  return L;
}

template <typename T>
struct GridArgs {
  const T* w;
  const T* v0;
  T* d;
  T* v;
  T* scratch;
  int* flags;  // [G][kFlagStride]: the rounds each CTA published
  const unsigned char* stale;
  int warm;
  int full;
  int* n_full;
  int B;
  int k;
  int G;
  int log_rounds;  // rounds of the log: max(warm, full) (k - 1)
};

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a barrier of the W phase's warps alone (named barrier 1), and of the V
// replay's (named barrier 2)
__device__ __forceinline__ void w_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWThreads) : "memory");
}

__device__ __forceinline__ void r_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(kReplayThreads) : "memory");
}

__device__ __forceinline__ int load_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}

// every one of the G flags at least `target`: warp 0 polls them (relaxed
// loads, all of a pass in flight at once), then one acquire fence orders
// what the CTA reads after them; the W phase's warps (or with kAll the
// whole CTA) wait on warp 0. A wait that outlasts kWaitNs ends the launch
// (__trap(): the whole grid stops and the stream's next synchronisation
// reports the error).
template <bool kAll>
__device__ void wait_flags(const int* flags, int G, int target) {
  if (threadIdx.x < 32) {
    const unsigned long long start = global_ns();
    for (;;) {
      bool mine = true;
      for (int q = threadIdx.x; q < G; q += 32)
        mine = load_relaxed(flags + q * kFlagStride) >= target && mine;
      if (__all_sync(0xffffffffu, mine)) break;
      if (threadIdx.x == 0 && global_ns() - start >= kWaitNs) __trap();
    }
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  if (kAll)
    __syncthreads();
  else
    w_sync();
}

// this CTA's writes so far (the caller's barrier orders them), then its
// flag = value
__device__ __forceinline__ void set_flag(int* flag, int value) {
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(flag), "r"(value) : "memory");
  }
}

// `bytes` (a multiple of 16) from global memory (through L2 only: other CTAs
// wrote it) into shared memory, 16 bytes a W-phase thread at a time, not
// waited for
__device__ __forceinline__ void copy_in_async(void* dst, const void* src, long long bytes) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const char* from = static_cast<const char*>(src);
  for (long long c = threadIdx.x; c < bytes / 16; c += kWThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     base + 16 * static_cast<unsigned>(c)),
                 "l"(from + 16 * c)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

#ifdef JACOBI_GRID_PROFILE
// cycles of thread 0 of CTA 0 in each part of a round (the wait, the angles
// with the entering columns and the symmetrisation, the boundary slots'
// tiles beside the other slots' mailbox entries, the boundary slots'
// entries with the leaving columns and the flag, the other slots' tiles,
// the next round's plans), summed over the rounds; then the whole launch
// and the rounds (a build for measurement: profile_grid.py)
__device__ long long g_grid_profile[8];
// the global timer (ns) of thread 0 of every CTA (up to kStampCtas) when it
// published round t + 1 and when it saw every CTA publish it, for the
// rounds t of [kStampFrom, kStampFrom + kStampRounds)
constexpr int kStampCtas = 128, kStampFrom = 100, kStampRounds = 64;
__device__ long long g_grid_stamps[2][kStampCtas][kStampRounds];
#define PROFILE_STAMP(which, t)                                                    \
  if (threadIdx.x == 0 && blockIdx.x < kStampCtas && (t) >= kStampFrom &&          \
      (t) < kStampFrom + kStampRounds)                                             \
    g_grid_stamps[which][blockIdx.x][(t) - kStampFrom] = static_cast<long long>(global_ns())
#define PROFILE_START()                                                      \
  const bool prof_on = blockIdx.x == 0 && threadIdx.x == 0;                  \
  long long prof[6] = {0, 0, 0, 0, 0, 0};                                    \
  const long long prof_begin = clock64();                                    \
  long long prof_last = prof_begin
#define PROFILE_MARK(n)              \
  if (prof_on) {                     \
    const long long now = clock64(); \
    prof[n] += now - prof_last;      \
    prof_last = now;                 \
  }
#define PROFILE_END(rounds)                                  \
  if (prof_on) {                                             \
    for (int n = 0; n < 6; ++n) g_grid_profile[n] = prof[n]; \
    g_grid_profile[6] = clock64() - prof_begin;              \
    g_grid_profile[7] = rounds;                              \
  }
#else
#define PROFILE_START()
#define PROFILE_MARK(n)
#define PROFILE_END(rounds)
#define PROFILE_STAMP(which, t)
#endif

// V: rows [g k / G, (g+1) k / G) of V0 turned by every round of the log, a
// round as soon as the W phase has seen every CTA log it (`logged` counts
// the rounds, over the matrices in turn; one thread waits, the others at
// their barrier); a thread takes pair i for every row, kReplayUnroll rows'
// entries loaded before any is written.
template <typename T>
__device__ void replay_rows(const GridArgs<T>& a, const GridLayout<T>& lay, T* rows_buf,
                            const T* alog, const int* logged, int b, int rounds) {
  const int k = a.k, h = lay.h, g = blockIdx.x, G = a.G;
  const int rt = threadIdx.x - kWThreads;
  const int row0 = g * k / G, n = (g + 1) * k / G - row0;
  const long long at = (static_cast<long long>(b) * k + row0) * k;
  for (int e = rt; e < n * k; e += kReplayThreads) rows_buf[e] = __ldg(a.v0 + at + e);
  r_sync();
  const int base = b * rounds;
  int ready = 0;  // thread 0's view of the rounds logged
  for (int u = 0; u < rounds; ++u) {
    if (rt == 0) {
      while (ready <= u) {
        ready = load_acquire_cta(logged) - base;
        if (ready <= u) __nanosleep(64);
      }
    }
    r_sync();
    const int r = u % (k - 1);
    const T* L = alog + static_cast<long long>(u) * lay.log_stride;
    for (int i = rt; i < h; i += kReplayThreads) {
      const int x0 = label_at(i, r, k), x1 = label_at(k - 1 - i, r, k);
      const int p = x0 < x1 ? x0 : x1, q = x0 < x1 ? x1 : x0;
      const T cc = __ldcg(L + 2 * i), ss = __ldcg(L + 2 * i + 1);
      for (int j = 0; j < n; j += kReplayUnroll) {
        T vp[kReplayUnroll], vq[kReplayUnroll];
#pragma unroll
        for (int v = 0; v < kReplayUnroll; ++v)
          if (j + v < n) {
            vp[v] = rows_buf[(j + v) * k + p];
            vq[v] = rows_buf[(j + v) * k + q];
          }
#pragma unroll
        for (int v = 0; v < kReplayUnroll; ++v)
          if (j + v < n) {
            rows_buf[(j + v) * k + p] = turn_p(cc, ss, vp[v], vq[v]);
            rows_buf[(j + v) * k + q] = turn_q(cc, ss, vp[v], vq[v]);
          }
      }
    }
  }
  r_sync();
  for (int e = rt; e < n * k; e += kReplayThreads) a.v[at + e] = rows_buf[e];
}

template <typename T>
__global__ void __launch_bounds__(kGridThreads, 1) jacobi_eig_grid(GridArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, G = a.G;
  const GridLayout<T> lay = grid_layout<T>(k, G, a.log_rounds);
  const int h = lay.h, M = lay.M, ks = lay.ks;
  const int g = blockIdx.x;
  const int tid = threadIdx.x, nt = kWThreads;
  const long long kk = static_cast<long long>(k) * k;
  T* cols = reinterpret_cast<T*>(smem_raw);
  T* rows_buf = reinterpret_cast<T*>(smem_raw + lay.vrows);
  T* angles = reinterpret_cast<T*>(smem_raw + lay.angles);
  unsigned* pair_buf = reinterpret_cast<unsigned*>(smem_raw + lay.pairs);
  SlotPlan* plan_buf = reinterpret_cast<SlotPlan*>(smem_raw + lay.plans);
  SlotRings* ring_buf = reinterpret_cast<SlotRings*>(smem_raw + lay.rings);
  // rounds every CTA has logged, over the matrices
  int* logged = reinterpret_cast<int*>(smem_raw + lay.words);
  T* alog = a.scratch;
  T* mail = a.scratch + lay.mail;    // [2][h][2][2]
  T* inbox = a.scratch + lay.inbox;  // [2][G][2][ks]
  T* dump = a.scratch + lay.dump;    // [k][k]
  int* mine = a.flags + g * kFlagStride;
  const Arcs arc = arcs_of(g, h, G);
  const int m = arc.lb;
  const int rounds = (*a.stale != 0 ? a.full : a.warm) * (k - 1);
  if (tid == 0) *logged = 0;
  __syncthreads();

  if (tid >= kWThreads) {
    // the V replay's warps; at a matrix's end the CTA's two barriers (this
    // CTA done with it; every CTA done, or the launch ends)
    for (int b = 0; b < a.B; ++b) {
      replay_rows(a, lay, rows_buf, alog, logged, b, rounds);
      __syncthreads();
      __syncthreads();
    }
    return;
  }

  // the W phase's warps. The slot whose plan this thread keeps (plans t % 2)
  const int own = nt - 1 - tid;
  // round t's pairs (p | q << 16, pairs t % 2) and this CTA's slot plans
  // (plans t % 2), each stepped from the round before by the thread that
  // keeps it
  auto plan_round = [&](int t) {
    const int r = t % (k - 1);
    for (int i = tid; i < h; i += nt) {
      const int x0 = label_at(i, r, k), x1 = label_at(k - 1 - i, r, k);
      pair_buf[(t & 1) * h + i] = x0 < x1 ? (x0 | x1 << 16) : (x1 | x0 << 16);
    }
    if (own < m) {
      if (t == 0) {
        plan_slot(plan_buf[own], g, arc.lo + own, 0, k, h, G, M);
        slot_rings(ring_buf[own], g, arc.lo + own, h, G, M);
      } else {
        SlotPlan plan = plan_buf[((t - 1) & 1) * M + own];
        step_plan(plan, ring_buf[own], arc.lo + own, t, k);
        plan_buf[(t & 1) * M + own] = plan;
      }
    }
  };
  // round t's entering columns, from the inbox the neighbours wrote in
  // round t - 1 into the entry ends of this CTA's arcs (tops from CTA g - 1,
  // bottoms from CTA g + 1), not waited for
  auto columns_in = [&](int t) {
    const T* box = inbox + (static_cast<long long>(t & 1) * G + g) * 2 * ks;
    if (g >= 1)
      copy_in_async(cols + static_cast<long long>(ring(0, t, arc.lt)) * ks, box,
                    ks * static_cast<long long>(sizeof(T)));
    if (g < G - 1)
      copy_in_async(cols + static_cast<long long>(M + 1 + ring(0, t, arc.lb)) * ks, box + ks,
                    ks * static_cast<long long>(sizeof(T)));
    copy_commit();
  };
  // the column where slot plan p's side ends a round (a column that turns
  // into this CTA's other arc goes to its spare column)
  auto after = [&](const SlotPlan& p, int side) {
    return cols + static_cast<long long>(p.dst_rank[side] == g ? p.dst_col[side] : p.col[side]) *
                      ks;
  };

  int seq = 0;  // this CTA's flag before the matrix
  PROFILE_START();
  for (int b = 0; b < a.B; ++b) {
    const T* W = a.w + b * kk;
    // W's columns of the round-0 arrangement (slot s: top s, bottom k-1-s)
    plan_round(0);
    w_sync();
    for (long long e = tid; e < 2LL * m * k; e += nt) {
      const int row = static_cast<int>(e / (2 * m)), c = static_cast<int>(e % (2 * m));
      const SlotPlan& p = plan_buf[c >> 1];
      cols[static_cast<long long>(p.col[c & 1]) * ks + row] =
          __ldg(W + static_cast<long long>(row) * k + p.label[c & 1]);
    }
    w_sync();

    for (int t = 0; t < rounds; ++t) {
      const int r = t % (k - 1);
      const bool sym = t > 0 && r == 0;
      const SlotPlan* plans = plan_buf + (t & 1) * M;
      const unsigned* pairs = pair_buf + (t & 1) * h;
      PROFILE_MARK(5);
      if (t > 0) {
        wait_flags<false>(a.flags, G, seq + t);
        PROFILE_STAMP(1, t - 1);
        // every CTA has logged the rounds before t
        if (tid == 0) store_release_cta(logged, b * rounds + t);
        columns_in(t);
      }
      PROFILE_MARK(0);
      // the round's angles, every CTA all of them, from a_pp, a_qp, a_qq,
      // a_pq (W itself in round 0, else the mailboxes of the round before:
      // each label's entries where its column was one position back on the
      // circle); the owners log theirs
      const T* in = mail + (t & 1) * 4LL * h;
      for (int i = tid; i < h; i += nt) {
        const int x0 = label_at(i, r, k), x1 = label_at(k - 1 - i, r, k);
        const int P = x0 < x1 ? 0 : 1;
        T app, aqp, aqq, apq;
        if (t == 0) {
          const long long p = P == 0 ? x0 : x1, q = P == 0 ? x1 : x0;
          app = __ldg(W + p * k + p);
          aqp = __ldg(W + q * k + p);
          aqq = __ldg(W + q * k + q);
          apq = __ldg(W + p * k + q);
        } else {
          // positions i and k-1-i one round back (position 0 stays, 1 came
          // from k-1), each a slot's top (side 0) or bottom (side 1)
          const int b0 = i == 0 ? 0 : (i == 1 ? k - 1 : i - 1);
          const int b1 = k - 1 - i == 1 ? k - 1 : k - 2 - i;
          const int at0 = b0 < h ? 4 * b0 : 4 * (k - 1 - b0) + 2;
          const int at1 = b1 < h ? 4 * b1 : 4 * (k - 1 - b1) + 2;
          using Pair2 = typename Pair<T>::type;
          const Pair2 bp = __ldcg(reinterpret_cast<const Pair2*>(in + (P == 0 ? at0 : at1)));
          const Pair2 bq = __ldcg(reinterpret_cast<const Pair2*>(in + (P == 0 ? at1 : at0)));
          app = bp.x;
          aqp = bp.y;
          aqq = bq.x;
          apq = bq.y;
        }
        if (sym) {
          app = mul_rn(T(0.5), add_rn(app, app));
          aqq = mul_rn(T(0.5), add_rn(aqq, aqq));
          apq = mul_rn(T(0.5), add_rn(apq, aqp));
        }
        T c, s;
        rotation_rn(app, aqq, apq, c, s);
        angles[2 * i] = c;
        angles[2 * i + 1] = s;
        if (i >= arc.lo && i < arc.hi) {
          T* L = alog + static_cast<long long>(t) * lay.log_stride + 2 * i;
          L[0] = c;
          L[1] = s;
        }
      }
      if (t > 0) copy_wait_all();
      w_sync();
      if (sym) {
        // W <- (W + W^T) / 2: column b's row a from row b of the copy the
        // CTAs wrote at the sweep's end
        for (long long e = tid; e < 2LL * m * k; e += nt) {
          const int c = static_cast<int>(e / k), row = static_cast<int>(e % k);
          const SlotPlan& p = plans[c >> 1];
          T* colb = cols + static_cast<long long>(p.col[c & 1]) * ks;
          colb[row] = mul_rn(T(0.5), add_rn(colb[row], __ldcg(dump + static_cast<long long>(
                                                                       p.label[c & 1]) * k + row)));
        }
        w_sync();
      }
      PROFILE_MARK(1);

      // First what the other CTAs wait for: the mailbox of round t + 1
      // (each column's diagonal entry and its entry at its next partner's
      // row) and the columns that leave for another CTA (into its inbox of
      // round t + 1: tops arc 0, bottoms arc 1). The tiles of the slots
      // whose columns leave their arcs (slots lo and hi - 1; a leaving
      // column written into its spare column when it turns into this CTA's
      // other arc) write their leaving rows and mailbox entries there as
      // they turn them (turn_tile's operations); beside them, the other
      // slots' mailbox entries from their round-start columns without
      // writing them
      T* out = mail + ((t + 1) & 1) * 4LL * h + 4 * arc.lo;
      const int exits = m > 1 ? 2 : 1;
      for (int e = tid; e < exits * h + 4 * (m - exits); e += nt) {
        if (e < exits * h) {
          const int j = e < h ? 0 : m - 1, i = e < h ? e : e - h;
          const SlotPlan& p = plans[j];
          const bool P1 = p.label[0] > p.label[1];  // the top is q_j
          const unsigned pq = pairs[i];
          const int pi = static_cast<int>(pq & 0xffffu), qi = static_cast<int>(pq >> 16);
          const T ci = angles[2 * i], si = angles[2 * i + 1];
          const T cj = angles[2 * (arc.lo + j)], sj = angles[2 * (arc.lo + j) + 1];
          const T* colp = cols + static_cast<long long>(p.col[P1 ? 1 : 0]) * ks;
          const T* colq = cols + static_cast<long long>(p.col[P1 ? 0 : 1]) * ks;
          const T xpp = colp[pi], xqp = colp[qi], xpq = colq[pi], xqq = colq[qi];
          const T rpp = turn_p(ci, si, xpp, xqp), rpq = turn_p(ci, si, xpq, xqq);
          const T rqp = turn_q(ci, si, xpp, xqp), rqq = turn_q(ci, si, xpq, xqq);
          // column p_j, then q_j, at rows p_i and q_i
          const T pp = turn_p(cj, sj, rpp, rpq), qp = turn_q(cj, sj, rpp, rpq);
          const T pq_ = turn_p(cj, sj, rqp, rqq), qq = turn_q(cj, sj, rqp, rqq);
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const bool is_p = (side == 1) == P1;
            const T at_p = is_p ? pp : qp, at_q = is_p ? pq_ : qq;
            T* d = after(p, side);
            d[pi] = at_p;
            d[qi] = at_q;
            if (p.dst_rank[side] != g) {
              T* box = inbox + ((static_cast<long long>((t + 1) & 1) * G + p.dst_rank[side]) * 2 +
                                (p.dst_col[side] <= M ? 0 : 1)) *
                                   ks;
              box[pi] = at_p;
              box[qi] = at_q;
            }
#pragma unroll
            for (int which = 0; which < 2; ++which) {
              const int row = which ? p.next_partner[side] : p.label[side];
              if (row == pi || row == qi)
                out[4 * j + 2 * side + which] = row == pi ? at_p : at_q;
            }
          }
        } else {
          const int f = e - exits * h + 4;  // slots 1 .. m - 2
          const SlotPlan& p = plans[f >> 2];
          const int side = (f >> 1) & 1, P = p.label[0] < p.label[1] ? 0 : 1;
          const int x = f & 1 ? p.next_partner[side] : p.label[side];
          const int pos = position_of(x, r, k);
          const int i = pos < h ? pos : k - 1 - pos;
          const int j = arc.lo + (f >> 2);
          out[f] = peek_tile(pairs, angles, cols + static_cast<long long>(p.col[P]) * ks,
                             cols + static_cast<long long>(p.col[1 - P]) * ks, angles[2 * j],
                             angles[2 * j + 1], i, x == static_cast<int>(pairs[i] >> 16),
                             side != P);
        }
      }
      // (the other tiles below turn the columns the mailbox entries read)
      w_sync();
      PROFILE_MARK(2);
      // a sweep's last round publishes after the copy of W below
      const bool sweep_end = (t + 1) % (k - 1) == 0 && t + 1 < rounds;
      if (!sweep_end) {
        set_flag(mine, seq + t + 1);
        PROFILE_STAMP(0, t);
      }
      PROFILE_MARK(3);
      // Then the other slots' tiles, in place, while the others read
      for (int e = tid; e < (m - 2) * h; e += nt) {
        const int j = 1 + e / h, i = e % h;
        const SlotPlan& p = plans[j];
        const int P = p.label[0] < p.label[1] ? 0 : 1;
        T* colp = cols + static_cast<long long>(p.col[P]) * ks;
        T* colq = cols + static_cast<long long>(p.col[1 - P]) * ks;
        turn_tile(pairs, angles, colp, colq, colp, colq, angles[2 * (arc.lo + j)],
                  angles[2 * (arc.lo + j) + 1], i);
      }
      if (sweep_end) {
        // this CTA's columns into the row-major copy of W, where they lie
        // after the round
        w_sync();
        for (long long e = tid; e < 2LL * m * k; e += nt) {
          const int row = static_cast<int>(e / (2 * m)), c = static_cast<int>(e % (2 * m));
          const SlotPlan& p = plans[c >> 1];
          dump[static_cast<long long>(row) * k + p.label[c & 1]] = after(p, c & 1)[row];
        }
        w_sync();
        set_flag(mine, seq + t + 1);
      }
      PROFILE_MARK(4);
      // round t + 1's pairs and plans, which the data does not decide
      plan_round(t + 1);
    }

    // d: the diagonal of this CTA's columns after the last symmetrisation
    // (rounds is a whole number of sweeps: the round-0 arrangement again)
    if (rounds > 0) {
      wait_flags<false>(a.flags, G, seq + rounds);
      if (tid == 0) store_release_cta(logged, (b + 1) * rounds);
      columns_in(rounds);
      copy_wait_all();
    }
    w_sync();
    for (int c = tid; c < 2 * m; c += nt) {
      const SlotPlan& p = plan_buf[(rounds & 1) * M + (c >> 1)];
      const int l = p.label[c & 1];
      const T x = cols[static_cast<long long>(p.col[c & 1]) * ks + l];
      a.d[b * k + l] = rounds > 0 ? mul_rn(T(0.5), add_rn(x, x)) : x;
    }
    PROFILE_MARK(5);
    // the next matrix reuses the log and the buffers once every CTA's W
    // phase and V replay are done with this one
    __syncthreads();
    seq += rounds + 1;
    if (b + 1 < a.B) {
      set_flag(mine, seq);
      wait_flags<true>(a.flags, G, seq);
    } else {
      __syncthreads();
    }
  }
  PROFILE_END((*a.stale != 0 ? a.full : a.warm) * (k - 1));
  if (a.n_full != nullptr && g == 0 && tid == 0 && *a.stale != 0) *a.n_full += 1;
}

template <typename T>
int launch_grid(GridArgs<T> args, cudaStream_t stream) {
  const int k = args.k;
  if (args.B <= 0 || k < 2 || k % 2 != 0 || args.warm < 0 || args.full < 0 ||
      args.G < 1 || args.G > k / 2 || !args.w || !args.v0 || !args.d || !args.v ||
      !args.scratch || !args.flags || !args.stale)
    return static_cast<int>(cudaErrorInvalidValue);
  const GridLayout<T> lay = grid_layout<T>(k, args.G, args.log_rounds);
  if (lay.smem > kGridSmemMax || lay.h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobi_eig_grid<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGridSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)jacobi_eig_grid<T>, dim3(args.G), dim3(kGridThreads), params,
      static_cast<size_t>(lay.smem), stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T>
int jacobi_eig_grid_entry(const T* w, const T* v0, T* d, T* v, T* scratch, int* flags,
                          const unsigned char* stale, int warm, int full, int* n_full, int B,
                          int k, int ctas, void* stream) {
  GridArgs<T> args;
  args.w = w;
  args.v0 = v0;
  args.d = d;
  args.v = v;
  args.scratch = scratch;
  args.flags = flags;
  args.stale = stale;
  args.warm = warm;
  args.full = full;
  args.n_full = n_full;
  args.B = B;
  args.k = k;
  args.G = ctas;
  args.log_rounds = (warm > full ? warm : full) * (k - 1);
  return launch_grid(args, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace jacobi

extern "C" int jacobi_eig_grid_f32(const float* w, const float* v0, float* d, float* v,
                                   float* scratch, int* flags, const unsigned char* stale,
                                   int warm, int full, int* n_full, int B, int k, int ctas,
                                   void* stream) {
  return jacobi::jacobi_eig_grid_entry(w, v0, d, v, scratch, flags, stale, warm, full, n_full,
                                       B, k, ctas, stream);
}

extern "C" int jacobi_eig_grid_f64(const double* w, const double* v0, double* d, double* v,
                                   double* scratch, int* flags, const unsigned char* stale,
                                   int warm, int full, int* n_full, int B, int k, int ctas,
                                   void* stream) {
  return jacobi::jacobi_eig_grid_entry(w, v0, d, v, scratch, flags, stale, warm, full, n_full,
                                       B, k, ctas, stream);
}

extern "C" long long jacobi_eig_grid_scratch_f32(int k, int ctas, long long log_rounds) {
  return jacobi::grid_layout<float>(k, ctas, log_rounds).scratch;
}

extern "C" long long jacobi_eig_grid_scratch_f64(int k, int ctas, long long log_rounds) {
  return jacobi::grid_layout<double>(k, ctas, log_rounds).scratch;
}

extern "C" long long jacobi_eig_grid_smem_f32(int k, int ctas) {
  return jacobi::grid_layout<float>(k, ctas, 0).smem;
}

extern "C" long long jacobi_eig_grid_smem_f64(int k, int ctas) {
  return jacobi::grid_layout<double>(k, ctas, 0).smem;
}

#ifdef JACOBI_GRID_PROFILE
// the last launch's profile (g_grid_profile), then the SM clock in kHz,
// then its stamps (g_grid_stamps)
extern "C" int jacobi_eig_grid_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, jacobi::g_grid_profile, 8 * sizeof(long long));
  int khz = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  out[8] = khz;
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out + 9, jacobi::g_grid_stamps, sizeof(jacobi::g_grid_stamps));
  return static_cast<int>(err);
}
#endif

extern "C" int jacobi_eig_grid_flag_ints(int ctas) {
  return ctas * jacobi::kFlagStride;
}
