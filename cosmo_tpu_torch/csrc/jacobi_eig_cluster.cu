// Warm-started batched eigendecomposition of symmetric matrices of the large
// sides by cyclic Jacobi over the round-robin rounds, for NVIDIA Hopper
// (built for sm_90a): one thread-block cluster a matrix, W in the cluster's
// distributed shared memory for the whole call, one exchange between the
// cluster's CTAs a round, and V replayed afterwards from a log of the
// rounds' angles.
//
// Replaces, as jacobi_eig_large.cu does, the XLA loop of
// cosmo_tpu/ops/eigh.py::psd_project_amortized (jacobi_eigh(W, sweeps,
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
// ops/jacobi_eig.kernel_for sends a side here when W fits the shared memory
// of the largest cluster (cluster_smem_bytes); the other large sides stay on
// jacobi_eig_large.cu.
//
// Design.
//   * Ownership by column slot. Slot i of round r holds the pair (players[i],
//     players[k-1-i]) of the circle method: the top and the bottom column.
//     CTA `rank` of a cluster of C owns the slots [rank h / C, (rank+1) h / C)
//     (h = k/2) and all k rows of their columns, a column contiguous in its
//     shared memory. A round's row rotation mixes W[p, b] and W[q, b] inside
//     one column and its column rotation the two columns of one slot, so each
//     CTA turns its 2x2 tiles {p_i, q_i} x {p_j, q_j} (every pair i, its own
//     slots j) in place, given all k/2 angles of the round.
//   * The circle shift. Between rounds the tops move one slot right and the
//     bottoms one slot left; slot 0's top stays. A CTA keeps its tops and its
//     bottoms each as an arc of a ring with one spare column: the shift is an
//     offset that turns by one a round, not a copy. Only the column leaving an
//     arc's end crosses to the next arc (the neighbouring CTA, or the CTA's
//     own other arc at the ends of the circle), by one bulk copy
//     (cp.async.bulk) into that arc's spare column.
//   * The angles. After its tiles a CTA writes, for each of its columns, the
//     two entries that the next round's angle reads (its diagonal entry and
//     its entry at the row of its next partner) into its mailbox, and bulk-
//     copies the mailbox to every other CTA. Every CTA then computes all k/2
//     angles of the round from the mailboxes: the same inputs and code give
//     every CTA the same bits. The owner of a slot logs its (c, s).
//   * One exchange a round, no cluster barrier. The copies complete bytes on
//     a transaction barrier (mbarrier, one for the odd and one for the even
//     rounds) in the receiving CTA, which waits for its round's bytes: the
//     mailboxes of all the other CTAs and its entering columns. A CTA's data
//     reaches the others only after its tiles and mailbox are written, and a
//     CTA overwrites another's spare column or mailbox only after it has
//     received that CTA's mailbox of the round before, so the exchange also
//     orders every reuse of a buffer. The bulk copy of a leaving column has
//     read its source before the mailbox goes out.
//   * The symmetrisation. At a sweep's end the next round's angle inputs
//     become 0.5 (x + x) and 0.5 (a_pq + a_qp); W itself is symmetrised in
//     place between the sweeps: the owner of column b takes the entries
//     (a, b) with a < b, reads W[b, a] from column a's CTA and writes the
//     mean to both, so each entry is read and written by one thread; two
//     cluster barriers a sweep. The final diagonal is 0.5 (x + x), as the
//     plain version reads it after its last symmetrisation.
//   * V leaves the chain. Row i of V turns only by the round's (c, s) at the
//     columns p, q of row i. A second launch replays the angle log on V.
//     Where the clusters take at most a quarter of the SMs it runs on the
//     others while the W phase runs: it is the W phase's programmatic
//     dependent (it starts once every CTA of the W phase runs, so waiting on
//     them cannot deadlock), and each CTA publishes the rounds it has logged
//     every 8 rounds (a fence, then an atomic store) for the replay to
//     follow; elsewhere it runs after the W phase, which it would slow by
//     sharing its SMs. A replay block keeps 4 rows of V in shared memory and
//     stages the log in chunks of rounds (cp.async, double-buffered); its
//     threads take the round's pairs, each for all 4 rows, a block barrier a
//     round. The arithmetic per entry is the plain version's, so the bits
//     are.
//   * Launch: cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension (16
//     needs the non-portable size); clusters never wait on each other, so
//     no co-residency is needed. The wrapper chooses C
//     (ops/jacobi_eig.cluster_size) from the card's
//     cudaOccupancyMaxActiveClusters (jacobi_eig_cluster_max_active_*).
//
// What bounds it. The function's work (chip_smoke.eig_bound_ms) bounds it by
// operations. The kernel is still a chain of sweeps x (k - 1) rounds, each:
// the exchange's latency, the angles (IEEE divisions and square roots in a
// dependent chain), and a pass over the CTA's tiles in shared memory (24
// separately rounded operations a tile, issue-bound at k = 896 on a
// cluster's 16 SMs); the sequence, not the work, sets its time. Not used:
// wgmma (a round's rotations as a product would round otherwise), TMA
// tensor maps (W is read once).
//
// C interface (in the library of jacobi_proj.cu, loaded with ctypes):
// jacobi_eig_cluster_f32 / jacobi_eig_cluster_f64 launch the W phase and the
// V replay on the given stream and return the first launch error or
// cudaGetLastError() as an int; cudaErrorInvalidValue for k odd or < 2,
// B <= 0, warm or full < 0, a cluster size not in {1, 2, 4, 8, 16} or above
// k/2, W that does not fit the cluster's shared memory, or a null pointer
// other than n_full. `w` and `v0` are [B, k, k] inputs, `d` [B, k] and `v`
// [B, k, k] outputs, `alog` [B, max(warm, full) (k - 1), k/2, 2] scratch,
// `progress` [B, cluster] int32 scratch set to 0; `stale` a device byte;
// `n_full` a device int that counts full-sweep launches (or null).
// jacobi_eig_cluster_max_active_f32 / _f64 (k, cluster, out) write
// cudaOccupancyMaxActiveClusters for that side and cluster size.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "jacobi_circle.cuh"

namespace cg = cooperative_groups;

namespace jacobi {
namespace {

constexpr int kClusterMaxThreads = 1024;
constexpr int kSmemMax = 232448;  // bytes a block may use on sm_90
constexpr int kReplayThreads = 256;
constexpr int kReplayRows = 4;  // rows of V a replay block
constexpr int kReplayChunkBytes = 16384;
constexpr int kPublish = 8;  // the W phase publishes its log every 8 rounds

// shared memory of one CTA: the two round barriers; 2 (M + 1) columns (the
// tops ring, then the bottoms ring; CTA 0 keeps slot 0's fixed top in its
// tops ring's last column); the mailboxes [2][C][M][2][2] (a round's, the
// next's); the angles [h][2]; the pairs [2][h] (p | q << 16; a round's, the
// next's); the slot plans [2][M][10] ints (a round's, the next's).
// M = ceil(h / C) slots at most a CTA
template <typename T>
__host__ __device__ __forceinline__ long long cluster_smem_bytes(int k, int C) {
  const int h = k / 2, M = ceil_div(h, C);
  return 16 +
         (2LL * (M + 1) * column_stride<T>(k) + 8LL * C * M + 2LL * h) *
             static_cast<long long>(sizeof(T)) +
         8LL * h + 8LL * kSlotInts * M;
}

// threads of a CTA: one 2x2 tile each (h M), in whole warps, 64..1024
__host__ __device__ __forceinline__ int cluster_threads(int k, int C) {
  const int h = k / 2, tiles = h * ceil_div(h, C);
  const int warps = ceil_div(tiles, 32);
  return warps < 2 ? 64 : (warps > kClusterMaxThreads / 32 ? kClusterMaxThreads : 32 * warps);
}

// where column `label` lies in round t: (rank, column index in its ring)
__device__ __forceinline__ void locate(int label, int t, int k, int h, int C, int M,
                                       int& rank, int& col) {
  const int x = position_of(label, t % (k - 1), k);
  if (x == 0) {
    rank = 0;
    col = M;
    return;
  }
  const bool top = x < h;
  const int s = top ? x : k - 1 - x;
  rank = owner_of(s, h, C);
  const Arcs a = arcs_of(rank, h, C);
  col = top ? ring(s - a.top0, t, a.lt) : M + 1 + ring(a.hi - 1 - s, t, a.lb);
}

template <typename T>
struct ClusterArgs {
  const T* w;
  const T* v0;
  T* d;
  T* v;
  T* alog;        // the angle log
  int* progress;  // [B][C]: rounds each CTA has logged
  const unsigned char* stale;
  int warm;
  int full;
  int* n_full;
  int k;
  int log_rounds;  // rounds of the log a matrix: max(warm, full) (k - 1)
};

// distributed shared memory and the transaction barriers (mbarrier): a
// CTA's shared address, the same address in CTA `rank` of the cluster
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// arrive on the barrier, expecting `bytes` of copies to complete this phase
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) of this CTA's shared memory at `src` into CTA
// `rank`'s at the same layout's `dst`, completing on its barrier `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, unsigned src, unsigned bytes,
                                          unsigned bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(cluster_addr(dst, rank)),
      "r"(src), "r"(bytes), "r"(cluster_addr(bar, rank))
      : "memory");
}

// the bytes that CTA `rank` receives each round: the other CTAs' mailboxes
// (4 entries a slot) and the columns that enter its tops arc (from CTA
// rank - 1) and its bottoms arc (from CTA rank + 1)
template <typename T>
__device__ __forceinline__ unsigned bytes_in(int rank, int C, int h, int k, int m) {
  const int cols = (rank >= 1) + (rank < C - 1);
  return static_cast<unsigned>((4 * (h - m) + cols * column_stride<T>(k)) * sizeof(T));
}

#ifdef JACOBI_CLUSTER_PROFILE
// cycles of thread 0 of block 0 in each part of a round (the wait, the
// angles, the mailbox, the tiles), summed over the rounds, then the whole
// W phase and the rounds (a build for measurement: profile_cluster.py)
__device__ long long g_cluster_profile[6];
#define PROFILE_START()                                     \
  const bool prof_on = blockIdx.x == 0 && threadIdx.x == 0; \
  long long prof[4] = {0, 0, 0, 0};                         \
  const long long prof_begin = clock64();                   \
  long long prof_last = prof_begin
#define PROFILE_MARK(n)              \
  if (prof_on) {                     \
    const long long now = clock64(); \
    prof[n] += now - prof_last;      \
    prof_last = now;                 \
  }
#define PROFILE_END(rounds)                                     \
  if (prof_on) {                                                \
    for (int n = 0; n < 4; ++n) g_cluster_profile[n] = prof[n]; \
    g_cluster_profile[4] = clock64() - prof_begin;              \
    g_cluster_profile[5] = rounds;                              \
  }
#else
#define PROFILE_START()
#define PROFILE_MARK(n)
#define PROFILE_END(rounds)
#endif

template <typename T>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
    jacobi_eig_cluster_w(ClusterArgs<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, h = k / 2, ks = column_stride<T>(k);
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int M = ceil_div(h, C);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.x / C;
  const long long kk = static_cast<long long>(k) * k;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  T* cols = reinterpret_cast<T*>(smem_raw + 16);
  T* mail = cols + 2LL * (M + 1) * ks;  // [2][C][M][2][2]
  T* angles = mail + 8 * C * M;
  unsigned* pair_buf = reinterpret_cast<unsigned*>(angles + 2 * h);
  SlotPlan* plan_buf = reinterpret_cast<SlotPlan*>(pair_buf + 2 * h);
  const Arcs arc = arcs_of(rank, h, C);
  const int m = arc.lb;
  const int rounds = (*a.stale != 0 ? a.full : a.warm) * (k - 1);
  const unsigned in_bytes = bytes_in<T>(rank, C, h, k, m);
  // the tiles of the slots that no column leaves (1 .. m-2), per_slot
  // threads a slot (whole warps where there are 32 or more); the last warp
  // issues the copies and takes none
  const int share = m > 2 ? (nt - 32) / (m - 2) : nt;
  const int per_slot = share >= 32 ? share & ~31 : share;
  const int slot = 1 + tid / per_slot, first = tid % per_slot;
  // the slot whose plan this thread keeps (plans[t % 2])
  const int own = nt - 1 - tid;
  SlotPlan plan;
  SlotRings rings;
  const T* W = a.w + b * kk;
  T* logb = a.alog + b * static_cast<long long>(a.log_rounds) * h * 2;
  PROFILE_START();
  // every CTA of this launch is running: the V replay may start (it waits
  // for the rounds it needs through `progress`)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  int* logged = a.progress + blockIdx.x;

  // round t's pairs (p | q << 16, pairs t % 2) and this CTA's slot plans
  // (plans t % 2)
  auto plan_round = [&](int t) {
    const int r = t % (k - 1);
    for (int i = tid; i < h; i += nt) {
      const int x0 = label_at(i, r, k), x1 = label_at(k - 1 - i, r, k);
      pair_buf[(t & 1) * h + i] = x0 < x1 ? (x0 | x1 << 16) : (x1 | x0 << 16);
    }
    if (own < m) {
      if (t == 0) {
        plan_slot(plan_buf[own], rank, arc.lo + own, 0, k, h, C, M);
        plan = plan_buf[own];
        slot_rings(rings, rank, arc.lo + own, h, C, M);
      } else {
        step_plan(plan, rings, arc.lo + own, t, k);
        plan_buf[(t & 1) * M + own] = plan;
      }
    }
  };
  // pair tid's angle thread: where the columns at its two circle positions
  // (tid, k-1-tid) wrote their mailbox entries the round before (the same
  // every round: the slot, its owner and its side one position back), in
  // units of two entries
  int box[2] = {0, 0};
  for (int e = 0; e < 2 && tid < h; ++e) {
    const int pos = e == 0 ? tid : k - 1 - tid;
    const int back = pos == 0 ? 0 : (pos == 1 ? k - 1 : pos - 1);
    const bool top = back < h;
    const int sb = top ? back : k - 1 - back;
    const int owner = owner_of(sb, h, C);
    box[e] = 2 * (owner * M + sb - owner * h / C) + !top;
  }

  // W's columns of the round-0 arrangement (slot s: top s, bottom k-1-s);
  // the barriers of the odd and the even rounds, round 1's armed
  plan_round(0);
  __syncthreads();
  for (long long e = tid; e < 2LL * m * k; e += nt) {
    const int row = static_cast<int>(e / (2 * m)), c = static_cast<int>(e % (2 * m));
    const SlotPlan& p = plan_buf[c >> 1];
    cols[static_cast<long long>(p.col[c & 1]) * ks + row] =
        W[static_cast<long long>(row) * k + p.label[c & 1]];
  }
  if (tid == 0) {
    bar_init(smem_addr(&bars[0]));
    bar_init(smem_addr(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (rounds >= 1) bar_expect(smem_addr(&bars[1]), in_bytes);
  }
  cluster.sync();

  for (int t = 0; t < rounds; ++t) {
    const int r = t % (k - 1);
    const bool sym = t > 0 && r == 0;
    const SlotPlan* plans = plan_buf + (t & 1) * M;
    const unsigned* pairs = pair_buf + (t & 1) * h;
    if (t > 0) {
      // round t's mailboxes and entering columns from the other CTAs
      bar_wait(smem_addr(&bars[t & 1]), ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 1 <= rounds) bar_expect(smem_addr(&bars[(t + 1) & 1]), in_bytes);
      __syncthreads();
    }
    PROFILE_MARK(0);
    if (sym) {
      // W <- (W + W^T) / 2 in place: the owner of column b takes (a, b) for
      // a <= b, reading W[b, a] from column a's CTA
      cluster.sync();
      for (long long e = tid; e < 2LL * m * k; e += nt) {
        const int c = static_cast<int>(e / k), row = static_cast<int>(e % k);
        const SlotPlan& p = plans[c >> 1];
        const int lb = p.label[c & 1];
        if (row > lb) continue;
        T* colb = cols + static_cast<long long>(p.col[c & 1]) * ks;
        const T x = colb[row];
        if (row == lb) {
          colb[row] = mul_rn(T(0.5), add_rn(x, x));
          continue;
        }
        int qa, ca;
        locate(row, t, k, h, C, M, qa, ca);
        T* cola = cluster.map_shared_rank(cols, qa) + static_cast<long long>(ca) * ks;
        const T v = mul_rn(T(0.5), add_rn(x, cola[lb]));
        colb[row] = v;
        cola[lb] = v;
      }
      cluster.sync();
    }
    // the round's angles, every CTA all of them, from a_pp, a_qp, a_qq, a_pq
    // (W itself in round 0, else the mailboxes of the round before: each
    // label's column there, found from its circle position one round back);
    // the owners log theirs
    if (tid < h) {
      const int i = tid;
      const int x0 = label_at(i, r, k), x1 = label_at(k - 1 - i, r, k);
      const int P = x0 < x1 ? 0 : 1;
      T app, aqp, aqq, apq;
      if (t == 0) {
        const long long p = P == 0 ? x0 : x1, q = P == 0 ? x1 : x0;
        app = W[p * k + p];
        aqp = W[q * k + p];
        aqq = W[q * k + q];
        apq = W[p * k + q];
      } else {
        const T* in = mail + (t & 1) * 4 * C * M;
        const T* bp = in + 2 * box[P];
        const T* bq = in + 2 * box[1 - P];
        app = bp[0];
        aqp = bp[1];
        aqq = bq[0];
        apq = bq[1];
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
        T* L = logb + (static_cast<long long>(t) * h + i) * 2;
        L[0] = c;
        L[1] = s;
      }
    }
    __syncthreads();
    if (tid == nt - 2 && (t % kPublish == kPublish - 1 || t == rounds - 1)) {
      // this CTA's log entries up to round t, published for the V replay
      __threadfence();
      atomicExch(logged, t + 1);
    }
    PROFILE_MARK(1);

    // First what the other CTAs wait for. This CTA's mailbox of round t + 1
    // (each column's diagonal entry and its entry at its next partner's
    // row), computed from the round-start columns without writing them
    T* out = mail + ((t + 1) & 1) * 4 * C * M + 4 * rank * M;
    for (int e = tid; e < 4 * m; e += nt) {
      const SlotPlan& p = plans[e >> 2];
      const int side = (e >> 1) & 1, P = p.label[0] < p.label[1] ? 0 : 1;
      const int x = e & 1 ? p.next_partner[side] : p.label[side];
      const int pos = position_of(x, r, k);
      const int i = pos < h ? pos : k - 1 - pos;
      out[e] = peek_tile(pairs, angles, cols + static_cast<long long>(p.col[P]) * ks,
                         cols + static_cast<long long>(p.col[1 - P]) * ks,
                         angles[2 * (arc.lo + (e >> 2))], angles[2 * (arc.lo + (e >> 2)) + 1],
                         i, x == static_cast<int>(pairs[i] >> 16), side != P);
    }
    __syncthreads();
    // ... then the tiles of the slots whose columns leave their arcs (slots
    // lo and hi - 1), a leaving column written into its spare column here
    // when it turns into this CTA's other arc
    const int exits = m > 1 ? 2 : 1;
    for (int e = tid; e < exits * h; e += nt) {
      const int j = e < h ? 0 : m - 1, i = e < h ? e : e - h;
      const SlotPlan& p = plans[j];
      const int P = p.label[0] < p.label[1] ? 0 : 1;
      T* dst[2];
      for (int side = 0; side < 2; ++side)
        dst[side] = cols + static_cast<long long>(p.dst_rank[side] == rank ? p.dst_col[side]
                                                                           : p.col[side]) *
                               ks;
      turn_tile(pairs, angles, cols + static_cast<long long>(p.col[P]) * ks,
                cols + static_cast<long long>(p.col[1 - P]) * ks, dst[P], dst[1 - P],
                angles[2 * (arc.lo + j)], angles[2 * (arc.lo + j) + 1], i);
    }
    // the mailbox and the leaving columns, written by threads, before the
    // copies read them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    PROFILE_MARK(2);
    if (tid == nt - 1) {
      // the columns that leave an arc for another CTA, into its spare
      // column, read before the mailbox goes out; then the mailbox to every
      // other CTA
      const unsigned bar_next = smem_addr(&bars[(t + 1) & 1]);
      for (int side = 0; side < 2; ++side) {
        const SlotPlan& p = plans[side == 0 ? m - 1 : 0];
        if (p.dst_rank[side] != rank)
          bulk_copy(smem_addr(cols + static_cast<long long>(p.dst_col[side]) * ks),
                    smem_addr(cols + static_cast<long long>(p.col[side]) * ks),
                    ks * sizeof(T), bar_next, p.dst_rank[side]);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      for (int q = 0; q < C; ++q)
        if (q != rank) bulk_copy(smem_addr(out), smem_addr(out), 4 * m * sizeof(T), bar_next, q);
    }
    // Then the other slots' tiles, in place, while the copies travel
    if (slot < m - 1 && tid < nt - 32) {
      const SlotPlan& p = plans[slot];
      const int P = p.label[0] < p.label[1] ? 0 : 1;
      T* colp = cols + static_cast<long long>(p.col[P]) * ks;
      T* colq = cols + static_cast<long long>(p.col[1 - P]) * ks;
      const T cj = angles[2 * (arc.lo + slot)], sj = angles[2 * (arc.lo + slot) + 1];
      for (int i = first; i < h; i += per_slot)
        turn_tile(pairs, angles, colp, colq, colp, colq, cj, sj, i);
    }
#ifdef JACOBI_CLUSTER_PROFILE
    __syncthreads();
#endif
    PROFILE_MARK(3);
    // round t + 1's pairs and plans, which the data does not decide
    plan_round(t + 1);
  }

  // d: the diagonal of this CTA's columns, after the last symmetrisation
  // (rounds is a whole number of sweeps: the round-0 arrangement again)
  if (rounds > 0) bar_wait(smem_addr(&bars[rounds & 1]), ((rounds - 1) >> 1) & 1);
  __syncthreads();
  for (int c = tid; c < 2 * m; c += nt) {
    const SlotPlan& p = plan_buf[(rounds & 1) * M + (c >> 1)];
    const int l = p.label[c & 1];
    const T x = cols[static_cast<long long>(p.col[c & 1]) * ks + l];
    a.d[b * k + l] = rounds > 0 ? mul_rn(T(0.5), add_rn(x, x)) : x;
  }
  if (a.n_full != nullptr && blockIdx.x == 0 && tid == 0 && *a.stale != 0) *a.n_full += 1;
  PROFILE_END(rounds);
  // no CTA leaves while another may still address its shared memory
  cluster.sync();
}

// the rounds that all C CTAs of matrix b have logged (the V replay's
// lower bound on what it may read); read by one thread
__device__ __forceinline__ int logged_rounds(const int* progress, int C) {
  int least = 1 << 30;
  for (int q = 0; q < C; ++q) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(progress + q) : "memory");
    least = v < least ? v : least;
  }
  return least;
}

// V <- V0 turned by the logged rounds, as the W phase publishes them:
// kReplayRows rows of one matrix a block in shared memory; the log staged
// `chunk` rounds at a time (double-buffered, cp.async), each chunk once the
// W phase has published it; a thread takes pairs i = tid, tid + blockDim,
// ... of each round for all the block's rows (their entries loaded before
// any is turned), a block barrier a round
template <typename T>
__global__ void __launch_bounds__(kReplayThreads) jacobi_eig_cluster_v(ClusterArgs<T> a,
                                                                       int chunk, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = a.k, h = k / 2;
  const int per_matrix = ceil_div(k, kReplayRows);
  const long long b = blockIdx.x / per_matrix;
  const int row0 = (blockIdx.x % per_matrix) * kReplayRows;
  const int n = k - row0 < kReplayRows ? k - row0 : kReplayRows;
  int& ready = *reinterpret_cast<int*>(smem_raw);
  T* mine = reinterpret_cast<T*>(smem_raw + 16);
  T* buf = mine + kReplayRows * k;
  const int rounds = (*a.stale != 0 ? a.full : a.warm) * (k - 1);
  const T* L = a.alog + b * static_cast<long long>(a.log_rounds) * h * 2;
  const int* progress = a.progress + b * C;
  const long long at = (b * k + row0) * static_cast<long long>(k);
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) mine[e] = a.v0[at + e];

  const int chunks = ceil_div(rounds, chunk);
  // chunk c into buffer c % 2 once the W phase has published it (the wait
  // is bounded: a W phase that never publishes leaves V unwritten rather
  // than hanging); false on that bound
  auto stage = [&](int c) {
    if (c < chunks) {
      const int t0 = c * chunk, tn = rounds - t0 < chunk ? rounds - t0 : chunk;
      if (threadIdx.x == 0) {
        int seen = logged_rounds(progress, C);
        for (long long spin = 0; seen < t0 + tn && spin < (1LL << 26); ++spin) {
          __nanosleep(256);
          seen = logged_rounds(progress, C);
        }
        ready = seen >= t0 + tn;
      }
      __syncthreads();
      if (!ready) return false;
      T* dst = buf + static_cast<long long>(c & 1) * chunk * h * 2;
      const T* src = L + static_cast<long long>(t0) * h * 2;
      for (int e = threadIdx.x; e < tn * h; e += blockDim.x)
        __pipeline_memcpy_async(dst + 2 * e, src + 2 * e, 2 * sizeof(T));
    }
    __pipeline_commit();
    return true;
  };
  if (!stage(0)) return;
  for (int c = 0; c < chunks; ++c) {
    if (!stage(c + 1)) return;
    __pipeline_wait_prior(1);
    __syncthreads();
    const T* cs = buf + static_cast<long long>(c & 1) * chunk * h * 2;
    const int t0 = c * chunk, tn = rounds - t0 < chunk ? rounds - t0 : chunk;
    for (int u = 0; u < tn; ++u) {
      const int r = (t0 + u) % (k - 1);
      for (int i = threadIdx.x; i < h; i += blockDim.x) {
        const int x0 = label_at(i, r, k), x1 = label_at(k - 1 - i, r, k);
        const int p = x0 < x1 ? x0 : x1, q = x0 < x1 ? x1 : x0;
        const T cc = cs[2 * (u * h + i)], ss = cs[2 * (u * h + i) + 1];
        T vp[kReplayRows], vq[kReplayRows];
#pragma unroll
        for (int j = 0; j < kReplayRows; ++j)
          if (j < n) {
            vp[j] = mine[j * k + p];
            vq[j] = mine[j * k + q];
          }
#pragma unroll
        for (int j = 0; j < kReplayRows; ++j)
          if (j < n) {
            mine[j * k + p] = turn_p(cc, ss, vp[j], vq[j]);
            mine[j * k + q] = turn_q(cc, ss, vp[j], vq[j]);
          }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < n * k; e += blockDim.x) a.v[at + e] = mine[e];
  // the replay ends after the W phase: what follows in the stream may read
  // the W phase's outputs once it has waited for this launch
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T>
int replay_chunk(int k) {
  const int per_round = k / 2 * 2 * static_cast<int>(sizeof(T));
  const int n = kReplayChunkBytes / per_round;
  return n > 0 ? n : 1;
}

template <typename T>
long long replay_smem_bytes(int k) {
  return 16 + (static_cast<long long>(kReplayRows) * k +
               2LL * replay_chunk<T>(k) * (k / 2) * 2) *
                  static_cast<long long>(sizeof(T));
}

bool valid_cluster(int k, int C) {
  return (C == 1 || C == 2 || C == 4 || C == 8 || C == 16) && C <= k / 2;
}

template <typename T>
cudaError_t prepare(int k, int C) {
  // once a type: the largest dynamic shared memory and the non-portable
  // cluster size 16 for the W phase, the replay's shared memory
  static bool done = false;
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(jacobi_eig_cluster_w<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(jacobi_eig_cluster_w<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(jacobi_eig_cluster_v<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    done = true;
  }
  // a CTA holds W and has a thread for each pair's angle
  if (!valid_cluster(k, C) || cluster_smem_bytes<T>(k, C) > kSmemMax ||
      cluster_threads(k, C) < k / 2)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
void w_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int B, int k, int C,
              cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg.blockDim = dim3(cluster_threads(k, C));
  cfg.dynamicSmemBytes = static_cast<size_t>(cluster_smem_bytes<T>(k, C));
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <typename T>
int launch_cluster(ClusterArgs<T> args, int B, int C, cudaStream_t stream) {
  const int k = args.k;
  if (B <= 0 || k < 2 || k % 2 != 0 || args.warm < 0 || args.full < 0 || !args.w ||
      !args.v0 || !args.d || !args.v || !args.alog || !args.progress || !args.stale)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>(k, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  w_config<T>(cfg, attr, B, k, C, stream);
  err = cudaLaunchKernelEx(&cfg, jacobi_eig_cluster_w<T>, args);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bytes = replay_smem_bytes<T>(k);
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  // the replay as the W phase's programmatic dependent, when the clusters
  // leave most SMs free (at most a quarter taken): it starts once every CTA
  // of the W phase runs and follows the W phase's published rounds; where
  // the clusters take more, the replay would share their SMs and slow them,
  // and it runs after them
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t vcfg = {};
  cudaLaunchAttribute vattr[1];
  vcfg.gridDim = dim3(static_cast<unsigned>(B) * ceil_div(k, kReplayRows));
  vcfg.blockDim = dim3(kReplayThreads);
  vcfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  vcfg.stream = stream;
  vattr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  vattr[0].val.programmaticStreamSerializationAllowed = 1;
  vcfg.attrs = vattr;
  vcfg.numAttrs = 4 * B * C <= sms ? 1 : 0;
  err = cudaLaunchKernelEx(&vcfg, jacobi_eig_cluster_v<T>, args, replay_chunk<T>(k), C);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T>
int max_active(int k, int C, int* out) {
  if (out == nullptr || k < 2 || k % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>(k, C);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  w_config<T>(cfg, attr, 1, k, C, nullptr);
  err = cudaOccupancyMaxActiveClusters(out, jacobi_eig_cluster_w<T>, &cfg);
  return static_cast<int>(err);
}

template <typename T>
int jacobi_eig_cluster_entry(const T* w, const T* v0, T* d, T* v, T* alog, int* progress,
                             const unsigned char* stale, int warm, int full, int* n_full,
                             int B, int k, int cluster, void* stream) {
  ClusterArgs<T> args;
  args.w = w;
  args.v0 = v0;
  args.d = d;
  args.v = v;
  args.alog = alog;
  args.progress = progress;
  args.stale = stale;
  args.warm = warm;
  args.full = full;
  args.n_full = n_full;
  args.k = k;
  args.log_rounds = (warm > full ? warm : full) * (k - 1);
  return launch_cluster(args, B, cluster, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace jacobi

extern "C" int jacobi_eig_cluster_f32(const float* w, const float* v0, float* d, float* v,
                                      float* alog, int* progress, const unsigned char* stale,
                                      int warm, int full, int* n_full, int B, int k,
                                      int cluster, void* stream) {
  return jacobi::jacobi_eig_cluster_entry(w, v0, d, v, alog, progress, stale, warm, full,
                                          n_full, B, k, cluster, stream);
}

extern "C" int jacobi_eig_cluster_f64(const double* w, const double* v0, double* d,
                                      double* v, double* alog, int* progress,
                                      const unsigned char* stale, int warm, int full,
                                      int* n_full, int B, int k, int cluster, void* stream) {
  return jacobi::jacobi_eig_cluster_entry(w, v0, d, v, alog, progress, stale, warm, full,
                                          n_full, B, k, cluster, stream);
}

extern "C" int jacobi_eig_cluster_max_active_f32(int k, int cluster, int* out) {
  return jacobi::max_active<float>(k, cluster, out);
}

extern "C" int jacobi_eig_cluster_max_active_f64(int k, int cluster, int* out) {
  return jacobi::max_active<double>(k, cluster, out);
}

#ifdef JACOBI_CLUSTER_PROFILE
// the last launch's profile (g_cluster_profile), then the SM clock in kHz
extern "C" int jacobi_eig_cluster_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, jacobi::g_cluster_profile, 6 * sizeof(long long));
  int khz = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  out[6] = khz;
  return static_cast<int>(err);
}
#endif
