"""Clique merging strategies.

Reference behavior: src/chordal_decomposition/clique_merging.jl and
clique_graph.jl.

* ``NoMerge`` — keep the raw supernodal clique tree.
* ``ParentChildMerge`` — Sun & Andersen (2014): traverse the clique tree in
  descending topological order, merge a clique into its parent when the
  fill-in or supernode-size thresholds allow (clique_merging.jl:278-285).
* ``CliqueGraphMerge`` (default) — Garstka/Cannon/Goulart (2019): build the
  *reduced clique graph* (union of all clique trees, Habib & Stacho),
  weight each edge by the projection-complexity saving
  |C1|^3 + |C2|^3 − |C1 ∪ C2|^3, then greedily merge the max-weight
  *permissible* edge while positive; finally rebuild a valid clique tree
  via a max-weight (intersection-cardinality) spanning tree
  (clique_merging.jl:221-357, :478-609).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Set, Tuple

import numpy as np

from .trees import DEAD, ROOT, CliqueTree, children_from_par, post_order


# ----------------------------------------------------------------------
# strategy: parent-child (tree based)
# ----------------------------------------------------------------------

def _fill_in(dim_c_snd, dim_c_sep, dim_p_snd, dim_p_sep):
    """Fill-in created by merging child into parent
    (reference: clique_merging.jl:641-645)."""
    dim_p = dim_p_snd + dim_p_sep
    dim_c = dim_c_snd + dim_c_sep
    return (dim_p - dim_c_sep) * (dim_c - dim_c_sep)


def merge_parent_child(t: CliqueTree, t_fill: int = 8, t_size: int = 8) -> None:
    """In-place ParentChildMerge (reference: clique_merging.jl:83-92,
    :178-201, :272-306)."""
    snd_child = children_from_par(t.snd_par)
    order0 = list(t.snd_post)
    # second-highest post position downwards (reference initialise!, :234-237)
    for pos in range(len(order0) - 2, -1, -1):
        c = int(order0[pos])
        p = int(t.snd_par[c])
        if p < 0:  # became dead/root through earlier merges (cannot happen
            continue  # for parent-child: children of merged c re-parent to p)
        do_merge = (
            _fill_in(len(t.snd[c]), len(t.sep[c]), len(t.snd[p]), len(t.sep[p]))
            <= t_fill
            or max(len(t.snd[c]), len(t.snd[p])) <= t_size
        )
        t.merge_log.clique_pairs.append((p, c))
        t.merge_log.decisions.append(bool(do_merge))
        if not do_merge:
            continue
        t.merge_log.num += 1
        # merge child c into parent p (reference merge_child!, :178-201)
        t.snd[p] |= t.snd[c]
        t.snd[c] = set()
        t.sep[c] = set()
        for g in snd_child[c]:
            t.snd_par[g] = p
            snd_child[p].append(g)
        t.snd_par[c] = DEAD
        snd_child[p].remove(c)
        snd_child[c] = []
        t.num -= 1
        if t.num == 1:
            break
    t.snd_post = post_order(t.snd_par, children_from_par(t.snd_par), t.num)


# ----------------------------------------------------------------------
# strategy: clique graph (default)
# ----------------------------------------------------------------------

def _complexity_weight(c1: Set[int], c2: Set[int]) -> float:
    """|C1|^3 + |C2|^3 - |C1 ∪ C2|^3 (reference: clique_merging.jl:403)."""
    n1, n2 = len(c1), len(c2)
    nm = len(c1 | c2)
    return float(n1**3 + n2**3 - nm**3)


def _padded_weight(c1: Set[int], c2: Set[int]) -> float:
    """TPU-aware merge weight: the compute model is the *padded bucket*
    cost (blocks are batched per padded size), so merging is free while the
    union stays inside the larger block's bucket and pays the full padded
    cubic cost when it crosses a bucket boundary. Small positive epsilon for
    in-bucket merges so overlap variables still get eliminated."""
    from ..ops.conedata import pad_side

    n1, n2 = len(c1), len(c2)
    nm = len(c1 | c2)
    p1, p2, pm = pad_side(n1), pad_side(n2), pad_side(nm)
    return float(p1**3 + p2**3 - pm**3) + 1e-3 * min(n1, n2)


def _reduced_clique_graph(seps: List[Set[int]], snd: List[Set[int]]):
    """Edges of the reduced clique graph (union of all clique trees),
    via the Habib–Stacho separator-component construction
    (reference: clique_graph.jl:16-46)."""
    edges: Set[Tuple[int, int]] = set()
    uniq_seps = {frozenset(s) for s in seps if len(s) > 0}
    # vertex -> containing cliques index, so finding the cliques that
    # contain a separator is an intersection of short lists instead of a
    # scan over all cliques per separator
    by_vertex: Dict[int, Set[int]] = {}
    for k, c in enumerate(snd):
        for v in c:
            by_vertex.setdefault(v, set()).add(k)
    for separator in sorted(uniq_seps, key=len, reverse=True):
        it = iter(separator)
        cand = set(by_vertex.get(next(it), ()))
        for v in it:
            cand &= by_vertex.get(v, set())
            if not cand:
                break
        clique_ind = sorted(cand)
        if len(clique_ind) < 2:
            continue
        # separator graph H: edge (a, b) iff C_a ∩ C_b strictly contains S
        H: Dict[int, List[int]] = {v: [] for v in clique_ind}
        for ii in range(len(clique_ind)):
            for jj in range(ii + 1, len(clique_ind)):
                ca, cb = clique_ind[ii], clique_ind[jj]
                if not (snd[ca] & snd[cb]) <= separator:
                    H[ca].append(cb)
                    H[cb].append(ca)
        # connected components of H
        comp_of: Dict[int, int] = {}
        comp_id = 0
        for v in clique_ind:
            if v in comp_of:
                continue
            stack = [v]
            while stack:
                u = stack.pop()
                if u in comp_of:
                    continue
                comp_of[u] = comp_id
                stack.extend(H[u])
            comp_id += 1
        # edge between cliques containing S in different components
        for ii in range(len(clique_ind)):
            for jj in range(ii + 1, len(clique_ind)):
                ca, cb = clique_ind[ii], clique_ind[jj]
                if comp_of[ca] != comp_of[cb]:
                    edges.add((max(ca, cb), min(ca, cb)))
    return edges


def _is_permissible(c1: int, c2: int, adj: Dict[int, Set[int]], snd: List[Set[int]]):
    """An edge is permissible iff for every common neighbor N:
    C1 ∩ N == C2 ∩ N (reference: clique_graph.jl:148-158)."""
    for nb in adj[c1] & adj[c2]:
        if (snd[c1] & snd[nb]) != (snd[c2] & snd[nb]):
            return False
    return True


def merge_clique_graph(t: CliqueTree, weight_fn=None) -> None:
    """In-place CliqueGraphMerge on a graph-mode tree; afterwards a valid
    clique tree is recomputed (reference: clique_merging.jl:147-165).

    The graph construction + merge loop run in native C++ when available
    (cosmo_tpu_torch.native.clique_graph_merge, identical weights/tie order);
    the pure-Python loop below is the fallback and the executable spec."""
    assert t.graph_mode
    weight = weight_fn or _complexity_weight
    native_mode = {id(_complexity_weight): 0, id(_padded_weight): 1}.get(id(weight))
    if native_mode is not None:
        from .. import native

        pads, pad_to = (), 1
        if native_mode == 1:
            from ..ops.conedata import GEOMETRIC_SIZES

            pads, pad_to = GEOMETRIC_SIZES, 8
        res = native.clique_graph_merge(t.snd, t.sep, native_mode, pads, pad_to)
        if res is not None:
            snd_sets, edges, pairs, decisions, n_merges = res
            t.snd = snd_sets
            t.num -= n_merges
            t.merge_log.clique_pairs.extend(pairs)
            t.merge_log.decisions.extend(decisions)
            t.merge_log.num += n_merges
            _clique_tree_from_graph(t, edges)
            return
    snd = t.snd
    edges = _reduced_clique_graph(t.sep, snd)
    w: Dict[Tuple[int, int], float] = {
        e: weight(snd[e[0]], snd[e[1]]) for e in edges
    }
    adj: Dict[int, Set[int]] = {k: set() for k in range(len(snd))}
    for (a, b) in edges:
        adj[a].add(b)
        adj[b].add(a)

    # lazy max-heap over edge weights: stale entries (weight changed or edge
    # deleted) are skipped on pop; updates push fresh entries
    heap = [(-wt, e) for e, wt in w.items()]
    heapq.heapify(heap)

    while t.num > 1 and w:
        # max-weight permissible edge (reference traverse, :252-269)
        cand = None
        deferred = []
        while heap:
            nwt, e = heapq.heappop(heap)
            cur = w.get(e)
            if cur is None or cur != -nwt:
                continue  # stale
            if _is_permissible(e[0], e[1], adj, snd):
                cand = e
                break
            deferred.append((nwt, e))  # valid but not permissible now
        for item in deferred:
            heapq.heappush(heap, item)
        if cand is None:
            break
        do_merge = w[cand] >= 0
        t.merge_log.clique_pairs.append(cand)
        t.merge_log.decisions.append(bool(do_merge))
        if not do_merge:
            break
        t.merge_log.num += 1
        c1, c2 = cand
        # merge c2 into c1 (reference merge_two_cliques!, :204-215)
        snd[c1] |= snd[c2]
        snd[c2] = set()
        t.num -= 1
        # update edges/weights (reference update_strategy!, :309-357)
        neighbors = set(adj[c1])
        new_neighbors = adj[c2] - neighbors - {c1}
        for nb in neighbors:
            if nb != c2:
                e2 = (max(c1, nb), min(c1, nb))
                w[e2] = weight(snd[c1], snd[nb])
                heapq.heappush(heap, (-w[e2], e2))
        for nb in new_neighbors:
            e2 = (max(c1, nb), min(c1, nb))
            w[e2] = weight(snd[c1], snd[nb])
            heapq.heappush(heap, (-w[e2], e2))
        # drop all edges touching c2
        for nb in adj[c2]:
            w.pop((max(c2, nb), min(c2, nb)), None)
            adj[nb].discard(c2)
        adj.pop(c2, None)
        adj[c1] |= new_neighbors
        for nb in new_neighbors:
            adj[nb].add(c1)

    _clique_tree_from_graph(t, w)


def _clique_tree_from_graph(t: CliqueTree, w: Dict[Tuple[int, int], float]) -> None:
    """Recompute a valid clique tree from the merged clique graph: max-weight
    (intersection cardinality) spanning tree + root choice + snd/sep split
    (reference: clique_merging.jl:478-609)."""
    snd = t.snd
    live = [k for k, s in enumerate(snd) if len(s) > 0]
    t.snd_par = np.full(len(snd), DEAD, dtype=np.int64)

    if t.num == 1:
        k = live[0]
        t.snd_par[k] = ROOT
        t.sep = [set() for _ in snd]
        t.snd_post = np.array([k], dtype=np.int64)
        t.graph_mode = False
        return

    # intersection weights on remaining edges (clique_intersections!, :478-489)
    iw = {
        e: len(snd[e[0]] & snd[e[1]])
        for e in w
        if len(snd[e[0]]) > 0 and len(snd[e[1]]) > 0
    }

    # Kruskal max-weight spanning tree (kruskal!, :502-527)
    parent_uf = {k: k for k in live}

    def find(x):
        while parent_uf[x] != x:
            parent_uf[x] = parent_uf[parent_uf[x]]
            x = parent_uf[x]
        return x

    mst: Dict[int, Set[int]] = {k: set() for k in live}
    n_found = 0
    # explicit (weight, edge) tie order: independent of dict insertion
    # order, so the native and pure-Python merge paths build the same tree
    for e in sorted(iw, key=lambda e: (-iw[e], e)):
        ra, rb = find(e[0]), find(e[1])
        if ra != rb:
            parent_uf[ra] = rb
            mst[e[0]].add(e[1])
            mst[e[1]].add(e[0])
            n_found += 1
            if n_found >= t.num - 1:
                break

    # root = clique containing the highest-order vertex (determine_parent_cliques!)
    v_last = int(t.post[-1])
    root = next(k for k in live if v_last in snd[k])
    t.snd_par[root] = ROOT
    stack = [root]
    visited = {root}
    while stack:
        c = stack.pop()
        for nb in mst[c]:
            if nb not in visited:
                visited.add(nb)
                t.snd_par[nb] = c
                stack.append(nb)

    t.snd_post = post_order(t.snd_par, children_from_par(t.snd_par), t.num)

    # split cliques into supernodes and separators (split_cliques!, :566-579)
    t.sep = [set() for _ in snd]
    for j in range(t.num - 1):
        c = int(t.snd_post[j])
        p = int(t.snd_par[c])
        t.sep[c] = snd[c] & snd[p]
        snd[c] = snd[c] - t.sep[c]
    t.graph_mode = False


class MergeStrategy:
    """Base class for user-defined merge strategies (the extension hook of
    the reference's strategy pattern, AbstractMergeStrategy +
    initialise!/traverse/evaluate/update_strategy!,
    clique_merging.jl:108-129).

    Set ``graph_based`` to choose the handover form: True (default) gets
    the supernodal tree in reduced-clique-graph mode (``tree.graph_mode``)
    and must leave a valid clique tree behind — the helper
    :func:`finish_graph_merge` rebuilds one from the merged graph; False
    gets a plain clique tree (like ``ParentChildMerge``). Implement
    ``__call__(tree)`` mutating the :class:`~cosmo_tpu_torch.chordal.trees
    .CliqueTree` in place (record decisions in ``tree.merge_log``).
    Pass an instance as ``Settings(merge_strategy=...)``.
    """

    graph_based: bool = True

    def __call__(self, tree: CliqueTree) -> None:
        raise NotImplementedError


class CliqueGraphMerge(MergeStrategy):
    """The default clique-graph strategy with a pluggable edge weight
    (reference: AbstractEdgeWeight / ComplexityWeight,
    clique_merging.jl:388-403). ``edge_weight(c1: set, c2: set) -> float``;
    edges merge greedily while the best permissible weight is >= 0."""

    def __init__(self, edge_weight=None):
        self.edge_weight = edge_weight

    def __call__(self, tree: CliqueTree) -> None:
        merge_clique_graph(tree, weight_fn=self.edge_weight)


def finish_graph_merge(t: CliqueTree, weights=None) -> None:
    """Rebuild a valid clique tree from a merged reduced clique graph
    (max-intersection Kruskal spanning tree + snd/sep split) — for
    graph-based user strategies (reference: clique_merging.jl:478-609)."""
    if weights is None:
        weights = {e: 0.0 for e in _reduced_clique_graph(t.sep, t.snd)}
    _clique_tree_from_graph(t, weights)


def merge_cliques(t: CliqueTree, strategy, t_fill: int = 8, t_size: int = 8) -> None:
    """Dispatch on the merge strategy (reference: clique_merging.jl:131-165).
    ``strategy``: one of the built-in strings, or a :class:`MergeStrategy`
    instance / any callable mutating the tree in place."""
    if not isinstance(strategy, str):
        if t.num <= 1:
            if t.graph_mode:
                finish_graph_merge(t)
            return
        strategy(t)
        if t.graph_mode:
            # tolerate strategies that merged but did not rebuild the tree
            finish_graph_merge(t)
        return
    if strategy == "none" or t.num <= 1:
        if t.graph_mode:
            # even without merging, graph mode must produce a tree again
            edges = _reduced_clique_graph(t.sep, t.snd)
            w = {e: 0.0 for e in edges}
            _clique_tree_from_graph(t, w)
        return
    if strategy == "parent_child":
        merge_parent_child(t, t_fill, t_size)
        return
    if strategy == "clique_graph":
        merge_clique_graph(t)
        return
    if strategy == "clique_graph_tpu":
        merge_clique_graph(t, weight_fn=_padded_weight)
        return
    raise ValueError(f"Unknown merge strategy: {strategy}")
