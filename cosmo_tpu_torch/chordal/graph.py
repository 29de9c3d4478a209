"""Sparsity-graph analysis: fill-reducing ordering + symbolic chordal extension.

Reference behavior: src/chordal_decomposition/trees.jl:608-642 (find_graph! /
connect_graph!) — the reference runs a *logical* (symbolic) QDLDL
factorization with AMD ordering on the aggregate sparsity pattern; the
pattern of the Cholesky factor L is a chordal extension of the graph.

Here: a pure-NumPy host-side implementation (setup-time only, never on the
device): a greedy minimum-degree ordering followed by a one-pass symbolic
Cholesky using the elimination-tree column-merge recurrence
``Struct(L_j) = Adj+(j) U ( U_{c : parent(c)=j} Struct(L_c) minus {j} )``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def min_degree_ordering(adj: List[set]) -> np.ndarray:
    """Greedy minimum-degree ordering of an undirected graph.

    ``adj`` is a list of neighbor sets (no self loops). Returns a permutation
    ``perm`` with perm[k] = original vertex eliminated at step k (the analog
    of the AMD permutation used by the reference via QDLDL, trees.jl:636).
    """
    n = len(adj)
    work = [set(s) for s in adj]
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(s) for s in work], dtype=np.int64)
    perm = np.empty(n, dtype=np.int64)
    INF = np.iinfo(np.int64).max

    for k in range(n):
        deg_masked = np.where(alive, degree, INF)
        v = int(np.argmin(deg_masked))
        perm[k] = v
        alive[v] = False
        nbrs = work[v]
        # eliminate v: connect its neighbors into a clique
        for u in nbrs:
            wu = work[u]
            wu.discard(v)
            wu.update(nbrs)
            wu.discard(u)
        for u in nbrs:
            degree[u] = len(work[u])
        work[v] = set()
    return perm


def symbolic_cholesky(adj: List[set], perm: np.ndarray) -> List[np.ndarray]:
    """Symbolic Cholesky of the permuted adjacency + identity.

    Returns ``cols`` where cols[j] is the sorted array of subdiagonal row
    indices of column j of L, in *permuted* coordinates.  This pattern is a
    chordal extension of the graph (reference: trees.jl:634-642).
    """
    n = len(adj)
    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)

    # permuted higher adjacency
    higher = [[] for _ in range(n)]
    for v in range(n):
        pv = iperm[v]
        for u in adj[v]:
            pu = iperm[u]
            if pu > pv:
                higher[pv].append(pu)

    cols: List[np.ndarray] = [None] * n
    children: List[List[int]] = [[] for _ in range(n)]
    for j in range(n):
        s = set(higher[j])
        for c in children[j]:
            s.update(int(x) for x in cols[c] if x != j)
        col = np.array(sorted(s), dtype=np.int64)
        cols[j] = col
        if col.size:
            children[int(col[0])].append(j)  # parent(j) = min Struct(L_j)
    return cols


def connect_graph(cols: List[np.ndarray]) -> List[np.ndarray]:
    """Ensure the filled graph is connected (reference: trees.jl:608-625):
    a column j < n-1 with no subdiagonal entry gets the edge (j+1, j)."""
    n = len(cols)
    for j in range(n - 1):
        if cols[j].size == 0:
            cols[j] = np.array([j + 1], dtype=np.int64)
    return cols


def adj_sets_from_edges(graph) -> List[set]:
    """Neighbor-set form of a ``(n, i, j)`` edge-array graph (pass-through
    for a list of sets) — only the pure-Python fallbacks need it."""
    if not isinstance(graph, tuple):
        return graph
    n, i, j = graph
    adj: List[set] = [set() for _ in range(int(n))]
    for u, v in zip(i, j):
        adj[int(u)].add(int(v))
    return adj


def chordal_extension(adj) -> Tuple[List[np.ndarray], np.ndarray]:
    """Full pipeline: ordering + symbolic factor + connectivity fix.

    ``adj`` is either a list of neighbor sets or the vectorized edge-array
    form ``(n, i, j)``. Returns (cols, perm): the L pattern in permuted
    coordinates and the ordering such that tree-vertex v corresponds to
    original vertex perm[v]. Uses the native C++ implementation when
    available (cosmo_tpu_torch.native); falls back to the pure-Python one.
    """
    from .. import native

    perm = native.min_degree_ordering(adj)
    if perm is None:
        perm = min_degree_ordering(adj_sets_from_edges(adj))
    cols = native.symbolic_cholesky(adj, perm)
    if cols is None:
        cols = symbolic_cholesky(adj_sets_from_edges(adj), perm)
    cols = connect_graph(cols)
    return cols, perm
