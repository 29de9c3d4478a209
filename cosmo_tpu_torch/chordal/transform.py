"""Clique-tree-based (compact) decomposition transform and its reverse.

Reference behavior: src/chordal_decomposition/transformations.jl:142-426
(augment_clique_based!/add_entries!) and chordal_decomposition.jl:129-311
(reverse_decomposition!/add_sub_blocks!/psd_complete!).

The compact transformation (Kim et al. 2011) re-rows the problem so that
every clique block of a decomposed PSD cone occupies contiguous rows, and
couples overlapping entries between a clique and its parent clique through
new variables with (+1, -1) consistency columns:

  child row:   u_k + s_child(i,j) = 0
  parent row:  (original data row for (i,j)) - u_k + s_par(i,j) = b(i,j)

so that summing all block contributions reproduces the original entry.

Everything here is host-side setup (NumPy); the output is just a bigger
conic problem plus static index maps for the reverse transform.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from ..models import cones as C
from .trees import CliqueTree


def tri_dim(r: int) -> int:
    return r * (r + 1) // 2


def tri_index(i: int, j: int) -> int:
    """svec index of (i, j), i <= j, column-major upper triangle (0-based)."""
    return j * (j + 1) // 2 + i


@dataclasses.dataclass
class SparsityPattern:
    """Chordal sparsity analysis of one decomposable PSD cone
    (reference: src/types.jl:192-215)."""

    tree: CliqueTree
    ordering: np.ndarray    # tree vertex -> original matrix index
    cone_index: int         # position of the cone in the original set list
    row_start: int          # first row of the cone in the original problem
    side: int               # original matrix side N


@dataclasses.dataclass
class ChordalInfo:
    """Everything needed to solve the decomposed problem and undo it."""

    problem: tuple          # (P, q, A, b, sets) of the decomposed problem
    m_orig: int
    n_orig: int
    sets_orig: list
    patterns: List[SparsityPattern]
    row_map: np.ndarray     # [m_new] -> original row index (total map)
    num_overlaps: int
    mode: str = "compact"   # "compact" | "standard"
    H: object = None        # standard mode: scipy selector matrix [m_orig, nH]
    S: object = None        # compact mode: scipy row selector [m_new, m_orig]
    # compact mode: decomposed-row indices of each overlap variable's +1
    # (child) and -1 (parent) entry — the structure behind the
    # overlap-block KKT preconditioner (ops/kkt.py OverlapPrecond)
    ov_child_rows: object = None   # int64 [num_overlaps]
    ov_parent_rows: object = None  # int64 [num_overlaps]

    def refresh_qb(self, q: np.ndarray, b: np.ndarray):
        """Re-derive the decomposed (q, b) from updated original vectors —
        the structure (A/P/index maps) is value-independent of q/b, which is
        what lets a Model cache the decomposition across update() re-solves
        (reference: the States caching flags, types.jl:330-337,
        setup.jl:22-61)."""
        q_new = np.concatenate([q, np.zeros(self.num_overlaps, dtype=q.dtype)])
        if self.mode == "standard":
            b_new = np.concatenate([b, np.zeros(self.num_overlaps, dtype=b.dtype)])
        else:
            b_new = self.S @ b
        return q_new, b_new

    def map_warm_start(self, x0: np.ndarray, s0: np.ndarray, mu0: np.ndarray):
        """Lift a warm start from the original space into the decomposed
        space (the forward companion of reverse_transform; reference warm
        starts compose with every solve, interface.jl:117-179).

        ``s`` entries are split evenly over their block occurrences (the
        reverse scatter-add then restores the original values); ``mu``
        entries are copied to every occurrence; overlap variables start
        at 0.
        """
        x_d = np.concatenate([x0, np.zeros(self.num_overlaps, dtype=x0.dtype)])
        if self.mode == "standard":
            h_rows = self.row_map[self.m_orig:]
            mult = np.bincount(h_rows, minlength=self.m_orig)[h_rows]
            s_d = np.concatenate([np.zeros(self.m_orig, dtype=s0.dtype),
                                  s0[h_rows] / np.maximum(mult, 1)])
            mu_d = np.concatenate([np.zeros(self.m_orig, dtype=mu0.dtype),
                                   mu0[h_rows]])
        else:
            # Never copy the m_orig-sized vectors (m_orig can be millions of
            # rows pre-decomposition and this container's host memory runs
            # at ~25 MB/s — a single 16 MB concatenate measured 0.85 s):
            # gather the m_new needed entries and mask the pad rows
            # (row_map == m_orig, the dump slot) to 0.
            mult = np.bincount(
                self.row_map, minlength=self.m_orig + 1
            )[self.row_map]
            safe = np.minimum(self.row_map, self.m_orig - 1)
            pad = self.row_map == self.m_orig
            s_d = np.where(pad, 0.0, s0[safe] / np.maximum(mult, 1))
            mu_d = np.where(pad, 0.0, mu0[safe])
        return x_d, s_d, mu_d


@lru_cache(maxsize=None)
def _block_entry_indices(nb: int):
    """Local (ii, jj) index arrays of an nb x nb block's upper triangle in
    svec (column-major) order — the block row layout
    (reference: transformations.jl:396-426). Cached: the transform calls
    this once per clique and clique sizes repeat heavily."""
    jj = np.repeat(np.arange(nb), np.arange(1, nb + 1))
    ii = np.arange(tri_dim(nb)) - jj * (jj + 1) // 2
    return ii, jj


def _sorted_member(sorted_arr: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Membership of ``vals`` in the sorted array (np.isin without the
    per-call sort)."""
    if sorted_arr.size == 0:
        return np.zeros(vals.shape, dtype=bool)
    pos = np.searchsorted(sorted_arr, vals)
    pos = np.minimum(pos, sorted_arr.size - 1)
    return sorted_arr[pos] == vals


def compact_transform(
    P,
    q: np.ndarray,
    A,
    b: np.ndarray,
    sets: list,
    patterns: List[SparsityPattern],
    pad_to: int = 1,
    pad_batch: int = 1,
    colpad_min: int = 512,
) -> ChordalInfo:
    """Build the decomposed problem (reference: augment_clique_based!,
    transformations.jl:152-200).

    Works for dense numpy and scipy sparse P/A: the transform is expressed
    as a row-selection operator S (new data rows <- original rows) applied
    to A and b, plus a sparse overlap block O of (+1, -1) columns:
    ``A_new = [S A  |  O]``.

    ``pad_to`` > 1 pads every clique block to its conedata bucket side (the
    geometric ladder, :func:`cosmo_tpu_torch.ops.conedata.pad_side`) *inside the
    problem*: the padded block gets ``tri_dim(kb)`` rows with the real
    clique occupying the leading ``tri_dim(nb)`` (the svec layout makes the
    real entries a contiguous prefix), and pad rows carry zero A-rows and
    b = 0 — pad coordinates are then exactly 0 along the whole ADMM
    trajectory (the projection of [[M,0],[0,0]] is [[Pi(M),0],[0,0]], the
    KKT rows are trivially satisfied). Cliques are grouped by padded side
    so every PSD bucket is uniform-side AND contiguous, which is the
    precondition of the selection-matmul projection fast path
    (ops/projections._psd_gather) — the measured top per-iteration cost
    otherwise (arbitrary-index [B,k,k] gathers).

    ``pad_batch`` > 1 additionally appends whole dummy blocks (all pad
    rows) so each side-group's block count is a multiple of the device
    count — batch sharding then never breaks contiguity
    (parallel/mesh.shard_cones keeps the fast path).
    """
    import scipy.sparse as sp

    from ..ops.conedata import pad_side

    m, n = A.shape
    pat_by_cone = {p.cone_index: p for p in patterns}

    def _kb(nblk: int) -> int:
        return pad_side(nblk, pad_to) if pad_to > 1 else nblk

    def _colpad(kb: int) -> bool:
        # giant blocks take column-padded svec storage
        # (models/cones.py PsdConeTriangleColPad): the projection's
        # tri <-> full conversion becomes one reshape and a mask, at the
        # cost of kb(kb-1)/2 structural-zero rows on the elementwise path
        return pad_to > 1 and kb >= colpad_min

    def _block_rows(kb: int) -> int:
        return kb * kb if _colpad(kb) else tri_dim(kb)

    # --- per-pattern block layout plan: [(clique or None, nb, kb), ...] ---
    # cliques grouped by padded side (stable within a group: reverse post
    # order, reference add_entries! loop num_cliques:-1:1), dummies appended
    # per group to round the count up to pad_batch
    plans = {}
    for p in patterns:
        t = p.tree
        groups: dict = {}
        for pos in range(t.num - 1, -1, -1):
            c = int(t.snd_post[pos])
            nblk = len(t.snd[c]) + len(t.sep[c])
            groups.setdefault(_kb(nblk), []).append((c, nblk))
        plan = []
        for kb in sorted(groups):
            for c, nblk in groups[kb]:
                plan.append((c, nblk, kb))
            if pad_batch > 1 and len(groups[kb]) >= pad_batch:
                # round the group up to the device count so batch sharding
                # keeps the contiguous fast path. Groups SMALLER than the
                # device count are left alone: parallel/mesh.shard_cones
                # batch-replicates them and shards the projection over the
                # matrix dimension instead — n_dev-fold dummy replication of
                # a giant block was the dominant sharding waste (a [1, 896]
                # clique padded to 8 blocks ran 8x 896^3 for 1 real block)
                plan.extend(
                    [(None, 0, kb)] * ((-len(groups[kb])) % pad_batch)
                )
        plans[p.cone_index] = plan

    # --- sizes ---
    num_overlaps = 0
    m_new = 0
    for k, cone in enumerate(sets):
        if k in pat_by_cone:
            t = pat_by_cone[k].tree
            for c, nblk, kb in plans[k]:
                m_new += _block_rows(kb)
                if c is not None:
                    num_overlaps += tri_dim(len(t.sep[c]))
        else:
            m_new += cone.dim
    n_new = n + num_overlaps

    # pad rows map to the dump slot m (no original row); reverse_transform
    # and map_warm_start extend their vectors by one slot accordingly
    row_map = np.full(m_new, m, dtype=np.int64)
    data_mask = np.zeros(m_new, dtype=bool)   # rows that carry original data
    ov_child_rows: list = []                  # +1 rows, one per overlap var
    ov_parent_rows: list = []                 # -1 rows
    sets_new: list = []

    row_ptr = 0
    row_start_orig = 0
    for k, cone in enumerate(sets):
        if k not in pat_by_cone:
            d = cone.dim
            row_map[row_ptr : row_ptr + d] = np.arange(
                row_start_orig, row_start_orig + d
            )
            data_mask[row_ptr : row_ptr + d] = True
            sets_new.append(cone)
            row_ptr += d
            row_start_orig += d
            continue

        pat = pat_by_cone[k]
        t = pat.tree
        ordering = pat.ordering
        rs = row_start_orig
        plan = plans[k]

        # row starts (and padded sides) per clique in layout order
        clique_row_start = {}
        clique_kb = {}
        rp = row_ptr
        for c, nblk, kb in plan:
            if c is not None:
                clique_row_start[c] = rp
                clique_kb[c] = kb
            rp += _block_rows(kb)

        ordering = np.ascontiguousarray(ordering, dtype=np.int64)
        for c, nblk, kb in plan:
            if c is None:
                # dummy block: all rows stay at the dump map / zero data
                sets_new.append(
                    C.PsdConeTriangleColPad(kb * kb) if _colpad(kb)
                    else C.PsdConeTriangle(tri_dim(kb)))
                continue
            snd_c = np.fromiter(t.snd[c], np.int64, len(t.snd[c]))
            sep_c = np.fromiter(t.sep[c], np.int64, len(t.sep[c]))
            snd_o = np.sort(ordering[snd_c])
            sep_o = np.sort(ordering[sep_c])
            clique_sorted = np.sort(np.concatenate([snd_o, sep_o]))
            nb = clique_sorted.size
            in_sep = _sorted_member(sep_o, clique_sorted)

            ii, jj = _block_entry_indices(nb)
            gi = clique_sorted[ii]            # original matrix indices
            gj = clique_sorted[jj]
            orig_rows = rs + gj * (gj + 1) // 2 + gi
            base = clique_row_start[c]
            if _colpad(kb):
                # column-padded storage: entry (i, j) at stride-kb slot
                new_rows = base + jj * kb + ii
            else:
                # svec entries of the real nb x nb block are the contiguous
                # prefix of the padded block's rows (column-major triangle)
                new_rows = base + np.arange(orig_rows.size)
            row_map[new_rows] = orig_rows
            is_ov = in_sep[ii] & in_sep[jj]
            data_mask[new_rows] = ~is_ov

            if is_ov.any():
                par = int(t.snd_par[c])
                pc = t.snd[par] | t.sep[par]
                par_clique = np.sort(ordering[np.fromiter(pc, np.int64, len(pc))])
                par_row0 = clique_row_start[par]
                # positions of (gi, gj) inside the sorted parent clique
                pi = np.searchsorted(par_clique, gi[is_ov])
                pj = np.searchsorted(par_clique, gj[is_ov])
                kb_par = clique_kb[par]
                if _colpad(kb_par):
                    parent_rows = par_row0 + pj * kb_par + pi
                else:
                    parent_rows = par_row0 + pj * (pj + 1) // 2 + pi
                ov_child_rows.append(new_rows[is_ov])
                ov_parent_rows.append(parent_rows)

            sets_new.append(
                C.PsdConeTriangleColPad(kb * kb) if _colpad(kb)
                else C.PsdConeTriangle(tri_dim(kb)))

        row_ptr = rp
        row_start_orig += cone.dim

    # --- assemble A_new = [S A | O], b_new = S b ---
    data_rows = np.where(data_mask)[0]
    S = sp.csr_matrix(
        (np.ones(data_rows.size, dtype=b.dtype), (data_rows, row_map[data_rows])),
        shape=(m_new, m),
    )
    child = np.concatenate(ov_child_rows) if ov_child_rows else np.zeros(0, np.int64)
    parent = np.concatenate(ov_parent_rows) if ov_parent_rows else np.zeros(0, np.int64)
    ov_cols = np.arange(num_overlaps, dtype=np.int64)
    O = sp.csr_matrix(
        (
            np.concatenate([np.ones(num_overlaps), -np.ones(num_overlaps)]).astype(b.dtype),
            (np.concatenate([child, parent]), np.concatenate([ov_cols, ov_cols])),
        ),
        shape=(m_new, num_overlaps),
    )
    b_new = S @ b
    q_new = np.concatenate([q, np.zeros(num_overlaps, dtype=q.dtype)])

    if sp.issparse(A) or sp.issparse(P):
        A_csr = A if (sp.issparse(A) and A.format == "csr") else sp.csr_matrix(A)
        A_new = sp.hstack([S @ A_csr, O]).tocsr()
        P_new = sp.block_diag(
            [sp.csr_matrix(P), sp.csr_matrix((num_overlaps, num_overlaps), dtype=b.dtype)]
        ).tocsr()
    else:
        A_new = np.concatenate([S @ A, O.toarray()], axis=1)
        P_new = np.zeros((n_new, n_new), dtype=P.dtype)
        P_new[:n, :n] = P

    return ChordalInfo(
        problem=(P_new, q_new, A_new, b_new, sets_new),
        m_orig=m,
        n_orig=n,
        sets_orig=list(sets),
        patterns=patterns,
        row_map=row_map,
        num_overlaps=num_overlaps,
        S=S,
        ov_child_rows=child,
        ov_parent_rows=parent,
    )


def standard_transform(
    P,
    q: np.ndarray,
    A,
    b: np.ndarray,
    sets: list,
    patterns: List[SparsityPattern],
) -> ChordalInfo:
    """The "standard" (Agler-form) decomposition (reference:
    find_decomposition_matrix!/augment_system!, transformations.jl:5-138):

        A_new = [[A, H], [0, -I]],  b_new = [b; 0]

    with a selector matrix H mapping stacked block entries back into the
    original cone rows. The first m rows become one ZeroSet; the new rows
    carry all cones (non-decomposed cones via identity columns of H,
    decomposed PSD cones as one block per clique). Supports both triangle
    (svec) and square (vec) PSD storage.
    """
    import scipy.sparse as sp

    m, n = A.shape
    pat_by_cone = {p.cone_index: p for p in patterns}

    H_rows: list = []      # original row of each H column, in column order
    sets_new: list = [C.ZeroSet(m)]
    row_start_orig = 0
    for k, cone in enumerate(sets):
        d = cone.dim
        if k not in pat_by_cone:
            H_rows.append(np.arange(row_start_orig, row_start_orig + d))
            sets_new.append(cone)
            row_start_orig += d
            continue
        pat = pat_by_cone[k]
        t = pat.tree
        ordering = pat.ordering
        square = isinstance(cone, C.PsdCone)
        r0 = row_start_orig
        side = pat.side
        # cliques in ascending post order (reference decompose!,
        # transformations.jl:62-82 iterates iii = 1:num_cliques)
        for pos in range(t.num):
            c = int(t.snd_post[pos])
            cl = np.sort(
                [int(ordering[v]) for v in (t.snd[c] | t.sep[c])]
            ).astype(np.int64)
            nb = cl.size
            if square:
                # column-stacked square storage: vec index = j * side + i
                jj, ii = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
                gi = cl[ii.ravel()]
                gj = cl[jj.ravel()]
                rows = r0 + gj * side + gi
                sets_new.append(C.PsdCone(nb * nb))
            else:
                ii, jj = _block_entry_indices(nb)
                gi = cl[ii]
                gj = cl[jj]
                rows = r0 + gj * (gj + 1) // 2 + gi
                sets_new.append(C.PsdConeTriangle(tri_dim(nb)))
            H_rows.append(rows)
        row_start_orig += d

    h_rows = np.concatenate(H_rows)
    nH = h_rows.size
    H = sp.csr_matrix(
        (np.ones(nH, dtype=b.dtype), (h_rows, np.arange(nH))), shape=(m, nH)
    )

    A_sp = sp.csr_matrix(A)
    A_new = sp.bmat(
        [[A_sp, H], [None, -sp.identity(nH, dtype=b.dtype, format="csr")]],
        format="csr",
    )
    b_new = np.concatenate([b, np.zeros(nH, dtype=b.dtype)])
    P_new = sp.block_diag(
        [sp.csr_matrix(P), sp.csr_matrix((nH, nH), dtype=b.dtype)], format="csr"
    )
    q_new = np.concatenate([q, np.zeros(nH, dtype=q.dtype)])
    if not sp.issparse(A):
        A_new = A_new.toarray()
        P_new = P_new.toarray()

    row_map = np.concatenate([np.arange(m, dtype=np.int64), h_rows])
    return ChordalInfo(
        problem=(P_new, q_new, A_new, b_new, sets_new),
        m_orig=m,
        n_orig=n,
        sets_orig=list(sets),
        patterns=patterns,
        row_map=row_map,
        num_overlaps=nH,
        mode="standard",
        H=H,
    )


def reverse_transform(
    info: ChordalInfo,
    x: np.ndarray,
    y: np.ndarray,
    s: np.ndarray,
    complete_dual: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map the decomposed solution back to the original problem
    (reference: reverse_decomposition!, chordal_decomposition.jl:129-213).

    ``s`` block entries scatter-add (the ±overlap contributions cancel);
    ``mu = -y`` entries overwrite (later blocks win, matching the reference's
    iteration order); optionally PSD-complete the dual.
    """
    # host numpy up front: ufunc.at / fancy indexing on a JAX array takes a
    # per-element fallback path (measured: 44 s vs 0.2 s on the 10k-node
    # SDP's 194k decomposed rows)
    x = np.asarray(x)
    y = np.asarray(y)
    s = np.asarray(s)
    x_o = x[: info.n_orig]
    # one extra dump slot absorbs pad rows (row_map == m_orig for the
    # block-padding rows the compact transform may add). Work directly in
    # y-space (mu = -y): every elementwise pass over an m_orig-sized array
    # is expensive on this container (first-touch page faults throttle
    # fresh allocations to tens of MB/s), so the mu negation passes the
    # old code made are folded into the scatters/completion.
    s_o = np.zeros(info.m_orig + 1, dtype=s.dtype)
    y_o = np.zeros(info.m_orig + 1, dtype=y.dtype)

    if info.mode == "standard":
        # s = H s_blocks; mu = H mu_blocks averaged over overlap counts
        # (reference: fill_dual_variables!, chordal_decomposition.jl:153-168)
        s_o[:-1] = info.H @ s[info.m_orig :]
        counts = np.asarray(info.H.sum(axis=1)).ravel()
        y_o[:-1] = info.H @ y[info.m_orig :] / np.maximum(counts, 1.0)
    else:
        np.add.at(s_o, info.row_map, s)
        # overwrite semantics, "last write wins" (reference add_blocks! order)
        rev = info.row_map[::-1]
        _, first_of_rev = np.unique(rev, return_index=True)
        last_idx = len(info.row_map) - 1 - first_of_rev
        y_o[info.row_map[last_idx]] = y[last_idx]
    s_o = s_o[:-1]
    y_o = y_o[:-1]

    if complete_dual:
        for pat in info.patterns:
            square = isinstance(info.sets_orig[pat.cone_index], C.PsdCone)
            # the completion reads/writes Y = -mu = y blockwise (it copies
            # the block out, never the full vector)
            _psd_complete_pattern_y(y_o, pat, square=square)

    return x_o, y_o, s_o


def _psd_complete_pattern_y(y: np.ndarray, pat: SparsityPattern, square: bool = False) -> None:
    """PSD completion of the dual block Y = y = -mu for one decomposed cone
    via clique-tree back-substitution (Vandenberghe, Chordal Graphs and
    Semidefinite Optimization, p.362; reference:
    chordal_decomposition.jl:263-311). Operates on the y-space vector in
    place (only the cone's own block is copied out)."""
    N = pat.side
    d = N * N if square else tri_dim(N)
    rows = slice(pat.row_start, pat.row_start + d)

    # unpack storage -> dense symmetric
    v = y[rows]
    if square:
        Y = v.reshape(N, N).copy()
        Y = 0.5 * (Y + Y.T)
    else:
        i_idx, j_idx = _tri_rows_cols(N)
        scale = np.where(i_idx == j_idx, 1.0, 1.0 / np.sqrt(2.0))
        Y = np.zeros((N, N), dtype=y.dtype)
        Y[i_idx, j_idx] = v * scale
        Y[j_idx, i_idx] = v * scale

    p = pat.ordering
    ip = np.empty(N, dtype=np.int64)
    ip[p] = np.arange(N)
    W = Y[np.ix_(p, p)].copy()

    t = pat.tree
    for jj in range(t.num - 2, -1, -1):
        c = int(t.snd_post[jj])
        nu = sorted(t.snd[c])
        alpha = sorted(t.sep[c])
        i0 = nu[0]
        excl = set(alpha) | set(nu)
        eta = [v_ for v_ in range(i0 + 1, N) if v_ not in excl]
        if not alpha or not eta:
            continue
        Waa = W[np.ix_(alpha, alpha)]
        Wan = W[np.ix_(alpha, nu)]
        try:
            Yblk = np.linalg.solve(Waa, Wan)
        except np.linalg.LinAlgError:
            Yblk = np.linalg.pinv(Waa) @ Wan
        W[np.ix_(eta, nu)] = W[np.ix_(eta, alpha)] @ Yblk
        W[np.ix_(nu, eta)] = W[np.ix_(eta, nu)].T

    Y_full = W[np.ix_(ip, ip)]
    if square:
        y[rows] = Y_full.T.reshape(-1)  # column-stacked: vec index = j*N + i
    else:
        out_scale = np.where(i_idx == j_idx, 1.0, np.sqrt(2.0))
        y[rows] = Y_full[i_idx, j_idx] * out_scale


def _tri_rows_cols(r: int):
    j = np.repeat(np.arange(r), np.arange(1, r + 1))
    i = np.arange(tri_dim(r)) - j * (j + 1) // 2
    return i, j
