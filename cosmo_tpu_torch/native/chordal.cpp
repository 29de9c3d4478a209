// Native host-side chordal analysis: greedy minimum-degree ordering and
// symbolic Cholesky (chordal extension).
//
// The reference reaches these through QDLDL's AMD + logical factorization
// (reference: src/chordal_decomposition/trees.jl:634-642). Here they are
// plain C++ called via ctypes — they run once per solve at setup time, but
// for 10k+-vertex aggregate sparsity graphs the pure-Python fallback
// (cosmo_tpu_torch/chordal/graph.py) takes minutes while this takes fractions of
// a second.
//
// Built with g++ at first use by cosmo_tpu_torch/native/__init__.py into
// cosmo_tpu_torch/_build/ (a copy of cosmo_tpu/native/chordal.cpp).
#include <cstdint>
#include <vector>
#include <algorithm>
#include <unordered_set>

extern "C" {

// Indices of nonzero entries of a double vector. Two-pass, cache-friendly;
// numpy's flatnonzero on a 5e7-element dense b costs ~0.3 s (one sweep per
// 10k-node decomposition, decompose.py _aggregate_sparsity), this ~0.05 s.
//  x       : [n] values
//  out     : [n] buffer (only the first <return value> entries written)
//  returns : number of nonzeros
int64_t nonzero_f64(int64_t n, const double* x, int64_t* out) {
    int64_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
        // branchless-ish: write then conditionally advance
        out[k] = i;
        k += (x[i] != 0.0);
    }
    return k;
}

// Greedy minimum-degree ordering.
//  n        : number of vertices
//  nnz      : number of (undirected, deduplicated, no-self-loop) edges * 2
//  adj_i/j  : edge endpoints, both directions present
//  perm_out : [n] vertex eliminated at step k
int64_t min_degree(int64_t n, int64_t nnz, const int64_t* adj_i,
                   const int64_t* adj_j, int64_t* perm_out) {
    std::vector<std::unordered_set<int64_t>> adj(n);
    for (int64_t e = 0; e < nnz; ++e) {
        if (adj_i[e] != adj_j[e]) adj[adj_i[e]].insert(adj_j[e]);
    }
    std::vector<char> alive(n, 1);
    // simple bucketed minimum-degree selection
    std::vector<int64_t> degree(n);
    for (int64_t v = 0; v < n; ++v) degree[v] = (int64_t)adj[v].size();

    for (int64_t k = 0; k < n; ++k) {
        // find min-degree alive vertex (linear scan; fine for <= ~1e5)
        int64_t best = -1, best_deg = INT64_MAX;
        for (int64_t v = 0; v < n; ++v) {
            if (alive[v] && degree[v] < best_deg) {
                best = v;
                best_deg = degree[v];
                if (best_deg == 0) break;
            }
        }
        perm_out[k] = best;
        alive[best] = 0;
        // eliminate: clique the neighborhood
        std::vector<int64_t> nbrs(adj[best].begin(), adj[best].end());
        for (int64_t u : nbrs) {
            adj[u].erase(best);
            for (int64_t w : nbrs) {
                if (w != u) adj[u].insert(w);
            }
        }
        for (int64_t u : nbrs) degree[u] = (int64_t)adj[u].size();
        adj[best].clear();
    }
    return 0;
}

// Symbolic Cholesky of the permuted adjacency + I.
//  perm     : ordering (tree vertex v <-> original vertex perm[v])
//  cap      : capacity of rowval_out
//  colptr_out : [n+1]
//  rowval_out : [cap] subdiagonal pattern of L, column-major (permuted coords)
// Returns nnz(L), or -(needed) if cap was insufficient.
int64_t symbolic_cholesky(int64_t n, int64_t nnz, const int64_t* adj_i,
                          const int64_t* adj_j, const int64_t* perm,
                          int64_t cap, int64_t* colptr_out,
                          int64_t* rowval_out) {
    std::vector<int64_t> iperm(n);
    for (int64_t v = 0; v < n; ++v) iperm[perm[v]] = v;

    // permuted higher adjacency
    std::vector<std::vector<int64_t>> higher(n);
    for (int64_t e = 0; e < nnz; ++e) {
        int64_t pu = iperm[adj_i[e]], pv = iperm[adj_j[e]];
        if (pv > pu) higher[pu].push_back(pv);
    }

    // Struct(L_j) = Adj+(j) U ( U_{c: parent(c)=j} Struct(L_c) \ {j} )
    std::vector<std::vector<int64_t>> cols(n);
    std::vector<std::vector<int64_t>> children(n);
    std::vector<int64_t> mark(n, -1);
    int64_t total = 0;
    for (int64_t j = 0; j < n; ++j) {
        std::vector<int64_t>& col = cols[j];
        for (int64_t r : higher[j]) {
            if (mark[r] != j) { mark[r] = j; col.push_back(r); }
        }
        for (int64_t c : children[j]) {
            for (int64_t r : cols[c]) {
                if (r != j && mark[r] != j) { mark[r] = j; col.push_back(r); }
            }
            cols[c].shrink_to_fit();
        }
        std::sort(col.begin(), col.end());
        total += (int64_t)col.size();
        if (!col.empty()) children[col[0]].push_back(j);
    }
    if (total > cap) return -total;
    int64_t ptr = 0;
    for (int64_t j = 0; j < n; ++j) {
        colptr_out[j] = ptr;
        for (int64_t r : cols[j]) rowval_out[ptr++] = r;
    }
    colptr_out[n] = ptr;
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Clique-graph merge (Garstka/Cannon/Goulart 2019): reduced clique graph via
// the Habib-Stacho separator-component construction, then greedy max-weight
// permissible merging with a lazy heap. Mirrors the pure-Python
// implementation in cosmo_tpu_torch/chordal/merging.py (reference:
// src/chordal_decomposition/clique_graph.jl:16-46, clique_merging.jl:147-357)
// exactly — same weights, same deterministic tie order — so the two paths
// produce identical merged trees (asserted by tests/test_chordal.py).
// The clique-tree rebuild (Kruskal + snd/sep split) stays in Python: it is
// cheap; only the O(#seps * |cand|^2) graph build and the merge loop are hot.

#include <queue>
#include <unordered_map>
#include <map>
#include <cmath>

namespace {

struct HeapEntry {
    double w;
    int64_t a, b;
};

// Pop order must match Python's heapq over (-w, (a, b)): largest weight
// first, ties -> lexicographically smallest (a, b).
struct HeapCmp {
    bool operator()(const HeapEntry& x, const HeapEntry& y) const {
        if (x.w != y.w) return x.w < y.w;
        if (x.a != y.a) return x.a > y.a;
        return x.b > y.b;
    }
};

int64_t isect_size(const std::vector<int64_t>& x, const std::vector<int64_t>& y) {
    int64_t n = 0;
    size_t i = 0, j = 0;
    while (i < x.size() && j < y.size()) {
        if (x[i] < y[j]) ++i;
        else if (x[i] > y[j]) ++j;
        else { ++n; ++i; ++j; }
    }
    return n;
}

std::vector<int64_t> isect(const std::vector<int64_t>& x, const std::vector<int64_t>& y) {
    std::vector<int64_t> out;
    std::set_intersection(x.begin(), x.end(), y.begin(), y.end(),
                          std::back_inserter(out));
    return out;
}

double cube(int64_t v) { return (double)v * (double)v * (double)v; }

}  // namespace

extern "C" {

// Inputs: full cliques `snd` + separators `sep` as CSR over sorted vertex
// lists; weight_mode 0 = |C1|^3+|C2|^3-|C1 u C2|^3, 1 = padded-bucket
// (pads = geometric ladder, pad_to = multiple; + 1e-3*min(|C1|,|C2|)).
// Outputs: merged full cliques (CSR, dead = empty), surviving weighted
// edges (the input to the Kruskal tree rebuild), and the merge log.
// Returns 0, or -1 if a capacity was insufficient (required sizes are then
// in *n_edges_out / *n_log_out / *snd_need_out).
int64_t clique_graph_merge(
    int64_t nc,
    const int64_t* snd_ptr, const int64_t* snd_val,
    const int64_t* sep_ptr, const int64_t* sep_val,
    int64_t weight_mode, const int64_t* pads, int64_t npads, int64_t pad_to,
    int64_t* snd_out_ptr, int64_t* snd_out_val, int64_t snd_cap,
    int64_t* snd_need_out,
    int64_t* edge_a, int64_t* edge_b, double* edge_w, int64_t edge_cap,
    int64_t* n_edges_out,
    int64_t* log_a, int64_t* log_b, int64_t* log_dec, int64_t log_cap,
    int64_t* n_log_out,
    int64_t* num_merges_out) {
    std::vector<std::vector<int64_t>> snd(nc);
    for (int64_t k = 0; k < nc; ++k)
        snd[k].assign(snd_val + snd_ptr[k], snd_val + snd_ptr[k + 1]);

    auto pad_side = [&](int64_t r) -> int64_t {
        if (pad_to <= 1) return r;
        for (int64_t p = 0; p < npads; ++p)
            if (pads[p] >= r && pads[p] % pad_to == 0) return pads[p];
        return ((r + pad_to - 1) / pad_to) * pad_to;
    };
    auto weight = [&](const std::vector<int64_t>& c1,
                      const std::vector<int64_t>& c2) -> double {
        int64_t n1 = (int64_t)c1.size(), n2 = (int64_t)c2.size();
        int64_t nm = n1 + n2 - isect_size(c1, c2);
        if (weight_mode == 1) {
            return cube(pad_side(n1)) + cube(pad_side(n2)) - cube(pad_side(nm))
                   + 1e-3 * (double)std::min(n1, n2);
        }
        return cube(n1) + cube(n2) - cube(nm);
    };

    // ---- reduced clique graph (Habib-Stacho separator components) ----
    // unique non-empty separators
    std::vector<std::vector<int64_t>> seps;
    for (int64_t k = 0; k < nc; ++k) {
        if (sep_ptr[k + 1] > sep_ptr[k])
            seps.emplace_back(sep_val + sep_ptr[k], sep_val + sep_ptr[k + 1]);
    }
    std::sort(seps.begin(), seps.end());
    seps.erase(std::unique(seps.begin(), seps.end()), seps.end());

    // vertex -> containing cliques (sorted short lists)
    std::unordered_map<int64_t, std::vector<int64_t>> by_vertex;
    for (int64_t k = 0; k < nc; ++k)
        for (int64_t v : snd[k]) by_vertex[v].push_back(k);

    std::map<std::pair<int64_t, int64_t>, double> w;  // ordered: edge -> weight
    std::vector<std::vector<int64_t>> adj(nc);        // unsorted neighbor lists
    std::vector<int64_t> cand, comp_of, Hdeg;
    for (const auto& S : seps) {
        // cliques containing every vertex of S: intersect the short lists
        auto it0 = by_vertex.find(S[0]);
        if (it0 == by_vertex.end()) continue;
        cand = it0->second;
        for (size_t si = 1; si < S.size() && !cand.empty(); ++si) {
            auto it = by_vertex.find(S[si]);
            if (it == by_vertex.end()) { cand.clear(); break; }
            cand = isect(cand, it->second);
        }
        int64_t m = (int64_t)cand.size();
        if (m < 2) continue;
        // separator graph H: edge iff |C_a n C_b| > |S| (S is contained in
        // both, so the intersection strictly contains S); then components
        comp_of.assign(m, -1);
        std::vector<std::vector<int64_t>> H(m);
        for (int64_t i = 0; i < m; ++i)
            for (int64_t j = i + 1; j < m; ++j)
                if (isect_size(snd[cand[i]], snd[cand[j]]) > (int64_t)S.size()) {
                    H[i].push_back(j);
                    H[j].push_back(i);
                }
        int64_t ncomp = 0;
        std::vector<int64_t> stack;
        for (int64_t i = 0; i < m; ++i) {
            if (comp_of[i] >= 0) continue;
            stack.push_back(i);
            while (!stack.empty()) {
                int64_t u = stack.back(); stack.pop_back();
                if (comp_of[u] >= 0) continue;
                comp_of[u] = ncomp;
                for (int64_t v : H[u]) stack.push_back(v);
            }
            ++ncomp;
        }
        for (int64_t i = 0; i < m; ++i)
            for (int64_t j = i + 1; j < m; ++j)
                if (comp_of[i] != comp_of[j]) {
                    int64_t a = std::max(cand[i], cand[j]);
                    int64_t b = std::min(cand[i], cand[j]);
                    w.emplace(std::make_pair(a, b), 0.0);
                }
    }
    for (auto& kv : w) {
        kv.second = weight(snd[kv.first.first], snd[kv.first.second]);
        adj[kv.first.first].push_back(kv.first.second);
        adj[kv.first.second].push_back(kv.first.first);
    }

    // ---- greedy merge with a lazy max-heap ----
    std::priority_queue<HeapEntry, std::vector<HeapEntry>, HeapCmp> heap;
    for (const auto& kv : w)
        heap.push({kv.second, kv.first.first, kv.first.second});

    auto adj_contains = [&](int64_t v, int64_t u) {
        for (int64_t x : adj[v]) if (x == u) return true;
        return false;
    };
    auto adj_erase = [&](int64_t v, int64_t u) {
        auto& av = adj[v];
        for (size_t i = 0; i < av.size(); ++i)
            if (av[i] == u) { av[i] = av.back(); av.pop_back(); return; }
    };
    auto permissible = [&](int64_t c1, int64_t c2) {
        for (int64_t nb : adj[c1]) {
            if (nb == c2 || !adj_contains(c2, nb)) continue;
            if (isect(snd[c1], snd[nb]) != isect(snd[c2], snd[nb])) return false;
        }
        return true;
    };

    int64_t num = nc, n_log = 0, n_merges = 0;
    bool log_overflow = false;
    std::vector<HeapEntry> deferred;
    std::vector<int64_t> tmp;
    while (num > 1 && !w.empty()) {
        bool found = false;
        HeapEntry cand_e{0.0, -1, -1};
        deferred.clear();
        while (!heap.empty()) {
            HeapEntry e = heap.top(); heap.pop();
            auto it = w.find({e.a, e.b});
            if (it == w.end() || it->second != e.w) continue;  // stale
            if (permissible(e.a, e.b)) { cand_e = e; found = true; break; }
            deferred.push_back(e);
        }
        for (const auto& e : deferred) heap.push(e);
        if (!found) break;
        bool do_merge = cand_e.w >= 0.0;
        if (n_log < log_cap) {
            log_a[n_log] = cand_e.a;
            log_b[n_log] = cand_e.b;
            log_dec[n_log] = do_merge ? 1 : 0;
        } else {
            log_overflow = true;
        }
        ++n_log;
        if (!do_merge) break;
        ++n_merges;
        int64_t c1 = cand_e.a, c2 = cand_e.b;
        // merge c2 into c1
        tmp.clear();
        std::set_union(snd[c1].begin(), snd[c1].end(),
                       snd[c2].begin(), snd[c2].end(), std::back_inserter(tmp));
        snd[c1].swap(tmp);
        snd[c2].clear();
        snd[c2].shrink_to_fit();
        --num;
        // recompute weights of surviving c1 edges; adopt c2's other edges
        std::vector<int64_t> neighbors = adj[c1];  // snapshot
        for (int64_t nb : neighbors) {
            if (nb == c2) continue;
            int64_t a = std::max(c1, nb), b = std::min(c1, nb);
            double wt = weight(snd[c1], snd[nb]);
            w[{a, b}] = wt;
            heap.push({wt, a, b});
        }
        for (int64_t nb : adj[c2]) {
            if (nb == c1) { }
            else if (!adj_contains(c1, nb)) {
                int64_t a = std::max(c1, nb), b = std::min(c1, nb);
                double wt = weight(snd[c1], snd[nb]);
                w[{a, b}] = wt;
                heap.push({wt, a, b});
                adj[c1].push_back(nb);
                adj[nb].push_back(c1);
            }
            w.erase({std::max(c2, nb), std::min(c2, nb)});
            adj_erase(nb, c2);
        }
        adj[c2].clear();
        adj_erase(c1, c2);
    }

    // ---- outputs ----
    int64_t snd_total = 0;
    for (int64_t k = 0; k < nc; ++k) snd_total += (int64_t)snd[k].size();
    int64_t n_edges = (int64_t)w.size();
    bool bad = false;
    if (snd_total > snd_cap) { *snd_need_out = snd_total; bad = true; }
    else *snd_need_out = snd_total;
    if (n_edges > edge_cap) { *n_edges_out = n_edges; bad = true; }
    else *n_edges_out = n_edges;
    *n_log_out = n_log;
    if (log_overflow) bad = true;
    if (bad) return -1;

    int64_t p = 0;
    for (int64_t k = 0; k < nc; ++k) {
        snd_out_ptr[k] = p;
        for (int64_t v : snd[k]) snd_out_val[p++] = v;
    }
    snd_out_ptr[nc] = p;
    int64_t e = 0;
    for (const auto& kv : w) {   // std::map: sorted by (a, b)
        edge_a[e] = kv.first.first;
        edge_b[e] = kv.first.second;
        edge_w[e] = kv.second;
        ++e;
    }
    *num_merges_out = n_merges;
    return 0;
}

}  // extern "C"
