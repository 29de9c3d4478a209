// The circle method's geometry for the Jacobi kernels that spread one
// matrix's columns over several CTAs (jacobi_eig_cluster.cu, a cluster a
// matrix; jacobi_eig_grid.cu, the co-resident grid): slot s of round r
// holds the pair (players[s], players[k-1-s]) of eigh._round_robin_rounds,
// its top and its bottom column. CTA `rank` of C owns the slots
// [rank h / C, (rank+1) h / C) (h = k/2) and all k rows of their columns; it
// keeps its tops and its bottoms each as an arc of a ring with one spare
// column, so the circle shift (tops one slot right, bottoms one slot left,
// slot 0's top fixed) is an offset that turns by one a round, and only the
// column leaving an arc's end crosses to the next arc. Each CTA turns its
// 2x2 tiles {p_i, q_i} x {p_j, q_j} (every pair i, its own slots j) in place
// with the plain version's rounding (jacobi_rn.cuh).
#pragma once

#include "jacobi_rn.cuh"

namespace jacobi {
namespace {

constexpr int kSlotInts = 10;  // a slot's round plan (SlotPlan)

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// a column's stride: k entries, rounded up to 16 bytes
template <typename T>
__host__ __device__ __forceinline__ int column_stride(int k) {
  const int per = 16 / static_cast<int>(sizeof(T));
  return ceil_div(k, per) * per;
}

// the label at circle position x (0..k-1) in round r: players[x] of
// _round_robin_rounds after r shifts (position 0 stays, the others turn)
__device__ __forceinline__ int label_at(int x, int r, int k) {
  if (x == 0) return 0;
  int v = x - 1 - r;
  if (v < 0) v += k - 1;
  return 1 + v;
}

// the circle position of label a in round r
__device__ __forceinline__ int position_of(int a, int r, int k) {
  if (a == 0) return 0;
  int v = a - 1 + r;
  if (v >= k - 1) v -= k - 1;
  return 1 + v;
}

// the slots of CTA `rank` and its two arcs: tops of slots [top0, hi), bottoms
// of slots [lo, hi) (slot 0's top never moves and is in no arc)
struct Arcs {
  int lo, hi, top0, lt, lb;
};

__device__ __forceinline__ Arcs arcs_of(int rank, int h, int C) {
  Arcs a;
  a.lo = rank * h / C;
  a.hi = (rank + 1) * h / C;
  a.top0 = a.lo > 1 ? a.lo : 1;
  a.lt = a.hi - a.top0;
  a.lb = a.hi - a.lo;
  return a;
}

// the CTA that owns slot s
__device__ __forceinline__ int owner_of(int s, int h, int C) {
  return ((s + 1) * C + h - 1) / h - 1;
}

// the ring column of arc position j (0 = the entry end) in round t, for an
// arc of n columns in a ring of n + 1: the offset turns back one a round, so
// an element keeps its column while it moves one position on
__device__ __forceinline__ int ring(int j, int t, int n) {
  const int v = j - t % (n + 1);
  return v < 0 ? v + n + 1 : v;
}

// a local slot's plan for round t: its columns, where a column that leaves
// its arc goes, their labels, and each label's partner in round t + 1
struct SlotPlan {
  int col[2];  // top, bottom
  int dst_rank[2];
  int dst_col[2];
  int label[2];
  int next_partner[2];
};
static_assert(sizeof(SlotPlan) == kSlotInts * sizeof(int), "slot plan size");

__device__ __noinline__ void plan_slot(SlotPlan& p, int rank, int s, int t, int k, int h,
                                       int C, int M) {
  const Arcs a = arcs_of(rank, h, C);
  const int r = t % (k - 1), rn = (t + 1) % (k - 1);
  p.label[0] = label_at(s, r, k);
  p.label[1] = label_at(k - 1 - s, r, k);
  p.col[0] = s == 0 ? M : ring(s - a.top0, t, a.lt);
  p.col[1] = M + 1 + ring(a.hi - 1 - s, t, a.lb);
  p.dst_rank[0] = p.dst_rank[1] = rank;
  p.dst_col[0] = p.col[0];
  p.dst_col[1] = p.col[1];
  if (s >= 1 && s == a.hi - 1) {
    // the top leaves its arc: into the next CTA's tops, or at the circle's
    // turn into this CTA's bottoms, at that arc's spare column
    const int d = rank < C - 1 ? rank + 1 : rank;
    const Arcs b = arcs_of(d, h, C);
    p.dst_rank[0] = d;
    p.dst_col[0] = rank < C - 1 ? ring(b.lt, t, b.lt) : M + 1 + ring(b.lb, t, b.lb);
  }
  if (s == a.lo) {
    // the bottom leaves its arc: into the previous CTA's bottoms, or at the
    // circle's other turn into the first non-empty tops arc
    if (rank > 0) {
      const Arcs b = arcs_of(rank - 1, h, C);
      p.dst_rank[1] = rank - 1;
      p.dst_col[1] = M + 1 + ring(b.lb, t, b.lb);
    } else if (a.lt > 0 || C > 1) {
      const int d = a.lt > 0 ? 0 : 1;
      const Arcs b = arcs_of(d, h, C);
      p.dst_rank[1] = d;
      p.dst_col[1] = ring(b.lt, t, b.lt);
    } else {
      // k = 2: the circle is one bottom column
      p.dst_col[1] = M + 1 + ring(a.lb, t, a.lb);
    }
  }
  for (int e = 0; e < 2; ++e)
    p.next_partner[e] = label_at(k - 1 - position_of(p.label[e], rn, k), rn, k);
}

// the rings of a slot's four column indices (its top and bottom columns,
// then where each goes): in each round an index turns back by one within
// its ring (first column, length), so the thread that keeps a slot's plan
// steps it from round to round (step_plan) in place of plan_slot
struct SlotRings {
  int base[4], len[4];
};

__device__ __forceinline__ void slot_rings(SlotRings& g, int rank, int s, int h, int C,
                                           int M) {
  const Arcs a = arcs_of(rank, h, C);
  g.base[0] = s == 0 ? M : 0;
  g.len[0] = s == 0 ? 1 : a.lt + 1;
  g.base[1] = M + 1;
  g.len[1] = a.lb + 1;
  g.base[2] = g.base[0];
  g.len[2] = g.len[0];
  g.base[3] = g.base[1];
  g.len[3] = g.len[1];
  if (s >= 1 && s == a.hi - 1) {
    g.base[2] = rank < C - 1 ? 0 : M + 1;
    g.len[2] = (rank < C - 1 ? arcs_of(rank + 1, h, C).lt : a.lb) + 1;
  }
  if (s == a.lo) {
    if (rank > 0) {
      g.len[3] = arcs_of(rank - 1, h, C).lb + 1;
    } else if (a.lt > 0 || C > 1) {
      g.base[3] = 0;
      g.len[3] = arcs_of(a.lt > 0 ? 0 : 1, h, C).lt + 1;
    }
  }
}

__device__ __forceinline__ int ring_step(int idx, int base, int len) {
  return idx == base ? base + len - 1 : idx - 1;
}

// slot s's plan of round t from its plan of round t - 1
__device__ __forceinline__ void step_plan(SlotPlan& p, const SlotRings& g, int s, int t,
                                          int k) {
  const int r = t % (k - 1), rn = r == k - 2 ? 0 : r + 1;
  for (int e = 0; e < 2; ++e) {
    p.col[e] = ring_step(p.col[e], g.base[e], g.len[e]);
    p.dst_col[e] = ring_step(p.dst_col[e], g.base[2 + e], g.len[2 + e]);
  }
  p.label[0] = label_at(s, r, k);
  p.label[1] = label_at(k - 1 - s, r, k);
  for (int e = 0; e < 2; ++e)
    p.next_partner[e] = label_at(k - 1 - position_of(p.label[e], rn, k), rn, k);
}

// the tile {p_i, q_i} x {p_j, q_j} of pair i in a round: rows p_i, q_i
// (p' = c p - s q, q' = s p + c q), then columns p_j, q_j, from the columns
// colp, colq into dp, dq (the same columns, in place, or the spare column
// that a leaving column goes to)
template <typename T>
__device__ __forceinline__ void turn_tile(const unsigned* pairs, const T* angles,
                                          const T* colp, const T* colq, T* dp, T* dq, T cj,
                                          T sj, int i) {
  const unsigned pq = pairs[i];
  const int pi = static_cast<int>(pq & 0xffffu), qi = static_cast<int>(pq >> 16);
  const T ci = angles[2 * i], si = angles[2 * i + 1];
  const T xpp = colp[pi], xqp = colp[qi], xpq = colq[pi], xqq = colq[qi];
  const T rpp = turn_p(ci, si, xpp, xqp), rpq = turn_p(ci, si, xpq, xqq);
  const T rqp = turn_q(ci, si, xpp, xqp), rqq = turn_q(ci, si, xpq, xqq);
  dp[pi] = turn_p(cj, sj, rpp, rpq);
  dq[pi] = turn_q(cj, sj, rpp, rpq);
  dp[qi] = turn_p(cj, sj, rqp, rqq);
  dq[qi] = turn_q(cj, sj, rqp, rqq);
}

// one entry of a tile's result without writing it: row x (p_i or q_i) of
// column p_j or q_j, with the same operations as turn_tile
template <typename T>
__device__ __forceinline__ T peek_tile(const unsigned* pairs, const T* angles, const T* colp,
                                       const T* colq, T cj, T sj, int i, bool row_q,
                                       bool col_q) {
  const unsigned pq = pairs[i];
  const int pi = static_cast<int>(pq & 0xffffu), qi = static_cast<int>(pq >> 16);
  const T ci = angles[2 * i], si = angles[2 * i + 1];
  const T xpp = colp[pi], xqp = colp[qi], xpq = colq[pi], xqq = colq[qi];
  const T rp = row_q ? turn_q(ci, si, xpp, xqp) : turn_p(ci, si, xpp, xqp);
  const T rq = row_q ? turn_q(ci, si, xpq, xqq) : turn_p(ci, si, xpq, xqq);
  return col_q ? turn_q(cj, sj, rp, rq) : turn_p(cj, sj, rp, rq);
}

}  // namespace
}  // namespace jacobi
