"""Supernodal elimination trees and clique trees.

Host-side (setup-time) graph analysis mirroring the reference's behavior
(src/chordal_decomposition/trees.jl): elimination tree, post order,
Pothen–Sun supernode partition, separator computation, and the
consecutive-supernode reordering needed for PSD completion.

All vertex indices are 0-based here (the reference is 1-based Julia);
"tree coordinates" refer to the permuted (ordering) coordinates, with
``ordering[v]`` mapping a tree vertex back to its original row/col index.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MergeLog:
    """Diagnostics of the merge phase (reference: trees.jl:38-45)."""

    num: int = 0
    clique_pairs: list = dataclasses.field(default_factory=list)
    decisions: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CliqueTree:
    """Clique tree / clique graph of a chordal sparsity pattern
    (reference SuperNodeTree, trees.jl:60-118).

    ``snd[k]``/``sep[k]`` hold tree-coordinate vertex sets; dead (merged)
    cliques have empty ``snd``.  In graph mode (CliqueGraphMerge) ``snd``
    holds the *full* cliques and ``sep`` is unused until a clique tree is
    recomputed after merging.
    """

    snd: List[set]
    sep: List[set]
    snd_par: np.ndarray          # parent clique index; -1 root/dead
    snd_post: np.ndarray         # post order over live cliques
    post: np.ndarray             # vertex post order (tree coords)
    par: np.ndarray              # vertex elimination-tree parents (-1 root)
    num: int                     # live clique count
    merge_log: MergeLog = dataclasses.field(default_factory=MergeLog)
    graph_mode: bool = False     # True until a tree is recomputed

    def clique(self, post_ind: int) -> set:
        """The clique with post order `post_ind` (snd ∪ sep)."""
        c = int(self.snd_post[post_ind])
        return self.snd[c] | self.sep[c]

    def n_blk(self, post_ind: int) -> int:
        c = int(self.snd_post[post_ind])
        return len(self.snd[c]) + len(self.sep[c])


def etree_from_cols(cols: List[np.ndarray]) -> np.ndarray:
    """Vertex elimination tree: parent(v) = first subdiagonal entry of
    column v of L (reference: trees.jl:166-175, :580-585)."""
    n = len(cols)
    par = np.full(n, -1, dtype=np.int64)
    for v in range(n):
        if cols[v].size:
            par[v] = cols[v][0]
    return par


def children_from_par(par: np.ndarray) -> List[List[int]]:
    child: List[List[int]] = [[] for _ in range(len(par))]
    for v, p in enumerate(par.tolist() if isinstance(par, np.ndarray) else par):
        if p >= 0:
            child[p].append(v)
    return child


ROOT = -1   # parent value of the root
DEAD = -2   # parent value of a merged-away clique


def post_order(par: np.ndarray, child: List[List[int]], nc: Optional[int] = None) -> np.ndarray:
    """Iterative DFS post order (reference: trees.jl:180-199): returns the
    vertices sorted so that every parent comes after its children. When
    merges removed cliques (``nc`` < len(par)), dead entries (par == DEAD)
    are excluded."""
    n = len(par)
    nc = n if nc is None else nc
    order = np.full(n, nc + 1, dtype=np.int64)
    root = int([v for v in range(n) if par[v] == ROOT][0])
    stack = [root]
    idx = nc - 1
    while stack:
        v = stack.pop()
        order[v] = idx
        idx -= 1
        stack.extend(child[v])
    post = np.argsort(order, kind="stable")[:nc]
    return post.astype(np.int64)


def higher_degrees(cols: List[np.ndarray]) -> np.ndarray:
    """|adj+(v)| in the filled graph (reference: trees.jl:590-600)."""
    return np.array([c.size for c in cols], dtype=np.int64)


def pothen_sun(par: np.ndarray, post: np.ndarray, degrees: np.ndarray):
    """Supernode partition (Pothen & Sun 1989; reference: trees.jl:390-464).

    Returns (snd_par, sn_ind): for a representative vertex v, sn_ind[v] < 0;
    otherwise sn_ind[v] is v's representative.  snd_par maps representative
    index (in the compressed list) to parent representative's compressed
    index, -1 for root.
    """
    n = len(par)
    sn_ind = np.full(n, -1, dtype=np.int64)   # < 0: representative
    supernode_par = np.full(n, -1, dtype=np.int64)
    children: List[List[int]] = [[] for _ in range(n)]
    root_ind = int(np.where(par < 0)[0][0])
    par_l = par.tolist()

    for v in post.tolist():
        p = par_l[v]
        children[root_ind if p < 0 else p].append(v)

        if p >= 0:
            if degrees[v] - 1 == degrees[p] and sn_ind[p] == -1:
                # v's supernode absorbs parent
                if sn_ind[v] < 0:
                    sn_ind[p] = v
                    sn_ind[v] -= 1
                else:
                    sn_ind[p] = sn_ind[v]
                    sn_ind[sn_ind[v]] -= 1
            else:
                if sn_ind[v] < 0:
                    supernode_par[v] = v
                else:
                    supernode_par[sn_ind[v]] = sn_ind[v]

        k = v if sn_ind[v] < 0 else int(sn_ind[v])
        for w in children[v]:
            l = w if sn_ind[w] < 0 else int(sn_ind[w])
            if l != k:
                supernode_par[l] = k

    repr_v = np.where(sn_ind < 0)[0]
    repr_pos = {int(r): i for i, r in enumerate(repr_v)}
    sn_par = np.full(len(repr_v), -1, dtype=np.int64)
    for i, r in enumerate(repr_v):
        p = int(supernode_par[r])
        # p == r means root supernode
        if p != r and p in repr_pos:
            sn_par[i] = repr_pos[p]
    return sn_par, sn_ind


def find_supernodes(par, post, degrees):
    """Group vertices into supernodes (reference: trees.jl:474-493).
    Returns (snd: list of sets, snd_par)."""
    sn_par, sn_ind = pothen_sun(par, post, degrees)
    n = len(par)
    groups = {}
    repr_v = np.where(sn_ind < 0)[0]
    for r in repr_v.tolist():
        groups[r] = {r}
    for v, f in enumerate(sn_ind.tolist()):
        if f >= 0:
            groups[f].add(v)
    snd = [groups[int(r)] for r in repr_v]
    return snd, sn_par


def find_separators(cols: List[np.ndarray], snd: List[set]) -> List[set]:
    """sep[k] = adj+(rep_k) \\ snd[k] where rep is the minimum (first
    eliminated) vertex of the supernode (reference: trees.jl:495-513)."""
    sep = []
    for s in snd:
        v_rep = min(s)
        # .tolist() yields Python ints in bulk — per-element int(x) on numpy
        # scalars dominated 10k-node setup (cProfile: 0.6 s of set.add).
        adj_plus = set(cols[v_rep].tolist())
        sep.append(adj_plus - s)
    return sep


def build_clique_tree(cols: List[np.ndarray], graph_mode: bool) -> CliqueTree:
    """Construct the supernodal clique tree of a chordal pattern L
    (reference SuperNodeTree constructor, trees.jl:72-102)."""
    par = etree_from_cols(cols)
    child = children_from_par(par)
    post = post_order(par, child)
    degrees = higher_degrees(cols)
    snd, snd_par = find_supernodes(par, post, degrees)
    snd_child = children_from_par(snd_par)
    snd_post = post_order(snd_par, snd_child)

    if graph_mode:
        # graph-based merging operates on full cliques; give up the tree
        sep = [set() for _ in snd]
        for k, s in enumerate(snd):
            v_rep = min(s)
            sp = set(cols[v_rep].tolist()) - s
            s |= sp
            sep[k] = sp
        snd_par = np.full(len(snd), -1, dtype=np.int64)
        return CliqueTree(
            snd=snd, sep=sep, snd_par=snd_par, snd_post=snd_post,
            post=post, par=par, num=len(snd), graph_mode=True,
        )
    sep = find_separators(cols, snd)
    return CliqueTree(
        snd=snd, sep=sep, snd_par=snd_par, snd_post=snd_post,
        post=post, par=par, num=len(snd), graph_mode=False,
    )


def reorder_snd_consecutively(t: CliqueTree, ordering: np.ndarray) -> np.ndarray:
    """Renumber tree vertices so each supernode occupies consecutive indices
    in clique post order; updates `ordering` accordingly
    (reference: trees.jl:545-569). Returns the new ordering."""
    n = len(t.post)
    p = np.zeros(n, dtype=np.int64)
    k = 0
    for c in t.snd_post:
        s = sorted(t.snd[int(c)])
        l = len(s)
        p[k : k + l] = s
        t.snd[int(c)] = set(range(k, k + l))
        k += l
    p_inv = np.empty(n, dtype=np.int64)
    p_inv[p] = np.arange(n)
    p_inv_l = p_inv.tolist()
    for i in range(len(t.sep)):
        t.sep[i] = {p_inv_l[v] for v in t.sep[i]}
    return ordering[p]
