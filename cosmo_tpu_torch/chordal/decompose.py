"""Chordal decomposition orchestration (host side).

Reference behavior: src/chordal_decomposition/chordal_decomposition.jl
(chordal_decomposition! / find_sparsity_patterns! / reverse_decomposition!).

Pipeline per decomposable PSD triangle cone:
 1. aggregate sparsity of its rows in A and b (+ the diagonal),
 2. chordal extension via minimum-degree ordering + symbolic Cholesky,
 3. supernodal clique tree (Pothen–Sun),
 4. clique merging (clique-graph / parent-child / none),
 5. consecutive-supernode reordering (for PSD completion),
 6. compact re-rowing of A, b with overlap consistency variables.

Everything runs at setup time on the host; the solver sees just a bigger
problem whose PSD cones are many small clique blocks — the axis that maps
onto batched projections on the device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..models import cones as C
from . import graph as graph_mod
from . import merging, trees
from .transform import (
    ChordalInfo,
    SparsityPattern,
    compact_transform,
    reverse_transform,
    standard_transform,
    tri_dim,
)


def _aggregate_sparsity(A, b_rows: np.ndarray, side: int, square: bool = False,
                        row0: int = 0):
    """Nonzero storage indices of the cone's rows [row0, row0+d) in A and b,
    with the diagonal always included
    (reference: chordal_decomposition.jl:100-115)."""
    import scipy.sparse as sp

    d = b_rows.shape[0]
    if square:
        diag = np.arange(side) * side + np.arange(side)
    else:
        diag = (np.arange(1, side + 1, dtype=np.int64) * np.arange(2, side + 2)) // 2 - 1
    if sp.issparse(A):
        A = A if A.format == "csr" else A.tocsr()
        ptr = A.indptr
        # rows with entries, via one searchsorted over the nnz indices —
        # O(nnz log m), not an O(m) indptr sweep (m can be 5e7+)
        lo, hi = ptr[row0], ptr[row0 + d]
        rows_nz = np.unique(
            np.searchsorted(
                ptr, np.arange(lo, hi, dtype=ptr.dtype), side="right"
            ) - 1 - row0
        )
        from .. import native

        b_nz = native.nonzero_f64(b_rows)  # ~5x numpy on 5e7-element b
        if b_nz is None:
            b_nz = np.flatnonzero(b_rows)
        return np.union1d(np.union1d(rows_nz, b_nz), diag)
    nz = np.any(A[row0 : row0 + d] != 0.0, axis=1)
    nz = nz | (b_rows != 0.0)
    nz[diag] = True
    return np.where(nz)[0]


def _adjacency_from_svec(nz: np.ndarray, side: int, square: bool = False):
    """Graph on the matrix vertices from the nonzero storage entries, as the
    edge-array form ``(n, i, j)`` consumed by :func:`graph.chordal_extension`
    (vectorized — no per-entry Python objects; the 10k-node setup spends
    its time here otherwise)."""
    if square:
        # column-stacked square storage: index = j * side + i
        j = nz // side
        i = nz % side
    else:
        # svec index k -> (i, j): j is the triangle column
        j = ((np.sqrt(8.0 * nz + 1.0) - 1.0) / 2.0).astype(np.int64)
        # guard float rounding at triangle boundaries
        j = np.where(j * (j + 1) // 2 > nz, j - 1, j)
        j = np.where((j + 1) * (j + 2) // 2 <= nz, j + 1, j)
        i = nz - j * (j + 1) // 2
    off = i != j
    i, j = i[off].astype(np.int64), j[off].astype(np.int64)
    # symmetrize + dedupe (square storage may carry both (i,j) and (j,i))
    key = np.unique(
        np.concatenate([i * side + j, j * side + i])
    )
    return side, key // side, key % side


def analyse_cone(
    A, b_rows: np.ndarray, side: int, merge_strategy,
    square: bool = False, row0: int = 0,
):
    """Sparsity analysis + clique tree + merging for one PSD cone.
    Returns (tree, ordering) or None if the cone is effectively dense.
    ``merge_strategy``: built-in string or a user
    :class:`~cosmo_tpu_torch.chordal.merging.MergeStrategy` / callable."""
    nz = _aggregate_sparsity(A, b_rows, side, square=square, row0=row0)
    if nz.size >= (side * side if square else tri_dim(side)):
        return None
    adj = _adjacency_from_svec(nz, side, square=square)
    cols, perm = graph_mod.chordal_extension(adj)
    graph_mode = (
        merge_strategy.startswith("clique_graph")
        if isinstance(merge_strategy, str)
        else bool(getattr(merge_strategy, "graph_based", True))
    )
    t = trees.build_clique_tree(cols, graph_mode=graph_mode)
    merging.merge_cliques(t, merge_strategy)
    if t.num <= 1:
        return None
    ordering = trees.reorder_snd_consecutively(t, perm)
    return t, ordering


def decompose(P, q, A, b, sets, settings, pad_batch: int = 1) -> Optional[ChordalInfo]:
    """Analyse all decomposable PSD cones and build the compact decomposed
    problem. Returns None when nothing decomposes.

    ``pad_batch``: device count of the target mesh — the compact transform
    rounds each side-group's block count up with dummy blocks so batch
    sharding keeps the uniform-contiguous bucket layout (transform.py)."""
    compact = bool(getattr(settings, "compact_transformation", True))
    import scipy.sparse as sp

    # One CSR conversion up front: analyse_cone and the transforms both need
    # row-major access, and each tocsr() of a tall A (m can be 5e7+) costs
    # ~0.6 s at 10k nodes.
    if sp.issparse(A) and A.format != "csr":
        A = A.tocsr()
    patterns: List[SparsityPattern] = []
    row = 0
    for k, cone in enumerate(sets):
        d = cone.dim
        is_tri = isinstance(cone, C.PsdConeTriangle) and not isinstance(
            cone, C.DensePsdConeTriangle
        )
        # the compact transformation handles triangle cones only (matching
        # the reference, transformations.jl:267-316); the standard (Agler)
        # transformation also decomposes square PsdCones
        is_sq = (
            not compact
            and isinstance(cone, C.PsdCone)
            and not isinstance(cone, C.DensePsdCone)
        )
        if (is_tri or is_sq) and getattr(cone, "decomposable", False):
            res = analyse_cone(
                A, b[row : row + d], cone.side,
                settings.merge_strategy, square=is_sq, row0=row,
            )
            if res is not None:
                t, ordering = res
                patterns.append(
                    SparsityPattern(
                        tree=t, ordering=ordering, cone_index=k,
                        row_start=row, side=cone.side,
                    )
                )
        row += d

    if not patterns:
        return None
    if compact:
        # block padding to the conedata bucket ladder: every decomposed PSD
        # bucket becomes uniform-side + contiguous, so the selection-matmul
        # projection fast path covers the whole decomposed solve
        return compact_transform(
            P, q, A, b, sets, patterns,
            pad_to=int(getattr(settings, "psd_pad_to", 1)),
            pad_batch=int(pad_batch),
            colpad_min=int(getattr(settings, "colpad_min", 512)),
        )
    return standard_transform(P, q, A, b, sets, patterns)


def reverse(chordal_info: ChordalInfo, x, y, s, settings):
    return reverse_transform(
        chordal_info, x, y, s, complete_dual=settings.complete_dual
    )
