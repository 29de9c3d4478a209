"""Block-diagonal direct KKT solve for structurally decoupled systems (the
port of ``cosmo_tpu.ops.blockkkt``).

The ADMM x-update solves the reduced SPD system

    M x = r1 + A' (rho .* r2),     M = P + sigma I + A' diag(rho) A.

``M_ij`` is nonzero only when columns i and j of A share a row (or P_ij is
nonzero), so under the connected components of that column-intersection
graph M is exactly block diagonal. For the compact chordal decomposition of
dual-form SDPs the components are a few columns each, and the solve becomes
batched dense algebra over thousands of k <= 64 blocks:

* :func:`analyze` (host, numpy) finds the components, pads them up a size
  ladder into buckets and emits the static index maps;
* :func:`factor` assembles each bucket's [N, k, k] blocks with one
  ``index_add_`` over the pair lists and caches their inverses from a
  batched Cholesky (at setup and on every rho change); with ``build_pair``
  it also assembles the blocks in double-f32, the exact M the float32
  refinement measures its residual against;
* :func:`solve` / :func:`solve_blockspace` apply them: per bucket one gather
  of the rows, batched einsums through the block-dense A and the cached
  inverses, and one scatter; with ``refine_steps`` the compensated
  right-hand side and refinement steps stay in the same bucket-local chain;
* :func:`compensated_residuals` measures the termination residuals in
  double-f32 through the block-dense A.

There is no hand-written kernel here: the batched Cholesky, triangular
solves and einsums are PyTorch's, the compensated arithmetic is elementwise
(ops/df32.py).

Under a device mesh (``cosmo_tpu_torch.parallel.shard_blockkkt``) each
bucket's components are split over the ranks: a rank holds the pair lists
of its own components only, assembles, factors and applies those, and one
sum reassembles x. The block-dense A and the
block-space x carry are dropped (:func:`supports_blockspace`), as in the
reference (``cosmo_tpu.ops.blockkkt:349, :545-555``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from . import df32
from .linops import _segment_sum, full_vals, matvec, rmatvec, to_device
from .shard import reduce_sum

# padded component-size ladder (one batched shape per bucket)
_LADDER = (1, 2, 4, 8, 16, 32, 64)
# the analysis gives up beyond these (cosmo_tpu.ops.blockkkt)
_MAX_PAIRS = 40_000_000
_MAX_BLOCK_MEM = 2 << 30  # bytes of inverse storage across buckets


@dataclasses.dataclass(frozen=True)
class BlockBucket:
    """One padded component bucket of the block-diagonal reduced system."""

    k: int                  # padded block side
    N: int                  # number of components in the bucket
    cols: Any = None        # int [N, k] member columns (pad = n); under a
    #                         mesh N and every list are the rank's own
    a_rows: Any = None      # int [nA] row of each A-pair (rho gather)
    a_pi: Any = None        # int [nA] row-sorted nnz index of entry a
    a_pj: Any = None        # int [nA] row-sorted nnz index of entry b
    a_tgt: Any = None       # int [nA] flat target in [N*k*k]
    p_idx: Any = None       # int [nP] row-sorted nnz index into P
    p_tgt: Any = None       # int [nP] flat target in [N*k*k]
    # the concatenated (A-pair, P-entry) stream sorted by target, for the
    # double-f32 assembly of the blocks (factor(build_pair=True))
    m_width: int = 0        # most entries on one target
    m_perm: Any = None      # int [nA+nP] sort-by-target order
    m_ptr: Any = None       # int [nUniq+1] segment pointer over the targets
    m_uniq: Any = None      # int [nUniq] distinct flat targets
    # block-structured A: every row of A lies inside one component, so A
    # restricted to the bucket is a dense [N, R, k] tensor
    R: int = 0              # padded rows per component (0: no dense A)
    row_ids: Any = None     # int [N, R] row of A (pad = m)
    av_idx: Any = None      # int [nAv] row-sorted nnz index
    av_tgt: Any = None      # int [nAv] flat target in [N*R*k]


@dataclasses.dataclass(frozen=True)
class BlockKKTMeta:
    """Static structure of the block-diagonal reduced KKT system."""

    n: int
    buckets: Tuple[BlockBucket, ...] = ()
    shard: Any = None       # the rank's Shard under a device mesh


def _canonical_coo(X):
    """The nnz order of linops.coo_from_scipy (row-major, through csr), so
    the device-side ``vals[idx]`` gathers hit the intended entries."""
    import scipy.sparse as sp

    Xc = sp.coo_matrix(sp.csr_matrix(X))
    r = np.asarray(Xc.row, dtype=np.int64)
    c = np.asarray(Xc.col, dtype=np.int64)
    p = np.lexsort((c, r))
    return r[p], c[p]


def target_stream(a_tgt, p_tgt) -> dict:
    """The ``m_*`` fields of a :class:`BlockBucket`: the concatenated
    (A-pair, P-entry) targets sorted, with their segment pointers."""
    all_tgt = np.concatenate([a_tgt, p_tgt])
    m_perm = np.argsort(all_tgt, kind="stable")
    m_uniq, m_counts = np.unique(all_tgt[m_perm], return_counts=True)
    m_ptr = np.zeros(m_uniq.size + 1, np.int64)
    np.cumsum(m_counts, out=m_ptr[1:])
    return dict(m_width=int(m_counts.max()) if m_counts.size else 0,
                m_perm=m_perm, m_ptr=m_ptr, m_uniq=m_uniq)


def analyze(P, A, max_block: int = 64) -> BlockKKTMeta | None:
    """Host-side structure analysis. Returns the static index maps (numpy;
    :func:`to_device` moves them) when the reduced system decouples into
    components of at most ``max_block`` columns, else None."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    m, n = A.shape
    ar, ac = _canonical_coo(A)
    prow, pcol = _canonical_coo(P)

    counts = np.bincount(ar, minlength=m).astype(np.int64)
    if counts.size and counts.max() > max_block:
        return None  # a row with t nnz forces a component of size >= t
    if int((counts**2).sum()) + prow.size > _MAX_PAIRS:
        return None

    # connectivity: chain edges within each row of A + off-diagonal P entries
    same = ar[1:] == ar[:-1]
    eu = np.concatenate([ac[:-1][same], prow[prow != pcol]])
    ev = np.concatenate([ac[1:][same], pcol[prow != pcol]])
    graph = sp.csr_matrix((np.ones(eu.size, np.int8), (eu, ev)), shape=(n, n))
    n_comp, labels = connected_components(graph, directed=False)
    sizes = np.bincount(labels, minlength=n_comp).astype(np.int64)
    if sizes.max() > max_block:
        return None

    # pad sizes up the ladder; memory guard on the cached inverses
    pad = np.empty(n_comp, np.int64)
    for k in _LADDER[::-1]:
        pad[sizes <= k] = k
    if int((pad**2).sum()) * 8 > _MAX_BLOCK_MEM:
        return None

    # slot position of each column inside its component (members ascending)
    order = np.argsort(labels, kind="stable")
    comp_start = np.zeros(n_comp + 1, np.int64)
    np.cumsum(sizes, out=comp_start[1:])
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n, dtype=np.int64) - comp_start[labels[order]]

    # A pairs: all ordered nnz pairs within each row, grouped by row arity
    row_start = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    pis, pjs, prs = [], [], []
    for t in np.unique(counts[counts > 0]):
        rows_t = np.nonzero(counts == t)[0]
        idx = row_start[rows_t][:, None] + np.arange(t, dtype=np.int64)
        shape = (rows_t.size, t, t)
        pis.append(np.broadcast_to(idx[:, :, None], shape).reshape(-1))
        pjs.append(np.broadcast_to(idx[:, None, :], shape).reshape(-1))
        prs.append(np.repeat(rows_t, t * t))
    a_pi = np.concatenate(pis) if pis else np.zeros(0, np.int64)
    a_pj = np.concatenate(pjs) if pjs else np.zeros(0, np.int64)
    a_row = np.concatenate(prs) if prs else np.zeros(0, np.int64)

    buckets = []
    for k in _LADDER:
        comps_b = np.nonzero(pad == k)[0]
        if comps_b.size == 0:
            continue
        N = int(comps_b.size)
        local = np.full(n_comp, -1, np.int64)
        local[comps_b] = np.arange(N, dtype=np.int64)

        cols_b = np.full((N, k), n, np.int64)
        cb_cols = np.nonzero(local[labels] >= 0)[0]
        cols_b[local[labels[cb_cols]], pos[cb_cols]] = cb_cols

        ca, cbb = ac[a_pi], ac[a_pj]
        amask = local[labels[ca]] >= 0
        tgt = (local[labels[ca[amask]]] * k + pos[ca[amask]]) * k + pos[cbb[amask]]

        pmask = local[labels[prow]] >= 0
        ptgt = (local[labels[prow[pmask]]] * k + pos[prow[pmask]]) * k + pos[
            pcol[pmask]
        ]

        # block-structured A: rows of this bucket's components, padded to
        # the bucket's exact max rows R
        rows_nz = np.nonzero(counts > 0)[0]
        rcomp = labels[ac[row_start[rows_nz]]]          # component per row
        rmask = local[rcomp] >= 0
        rows_b = rows_nz[rmask]
        rloc = local[rcomp[rmask]]
        rows_per = np.bincount(rloc, minlength=N)
        R = 1 if rows_b.size == 0 else int(rows_per.max())
        slot_order = np.argsort(rloc, kind="stable")
        slot = np.empty(rows_b.size, np.int64)
        rstart = np.zeros(N + 1, np.int64)
        np.cumsum(rows_per, out=rstart[1:])
        slot[slot_order] = (
            np.arange(rows_b.size, dtype=np.int64) - rstart[rloc[slot_order]]
        )
        if N * R * k > 200_000_000:
            # skewed rows per component would blow the dense-A cache (the
            # padded tensor is N*R*k); the COO applies take over
            R = 0
        row_ids = None
        if R:
            row_ids = np.full((N, R), m, np.int64)
            row_ids[rloc, slot] = rows_b
        # nnz placement: entry e of row r goes to (comp, row slot, col pos)
        ridx = np.repeat(np.arange(rows_b.size, dtype=np.int64), counts[rows_b])
        total = int(counts[rows_b].sum())
        off = np.zeros(rows_b.size + 1, np.int64)
        np.cumsum(counts[rows_b], out=off[1:])
        intra = np.arange(total, dtype=np.int64) - off[ridx]
        if R:
            av_idx = row_start[rows_b][ridx] + intra
            av_tgt = (rloc[ridx] * R + slot[ridx]) * k + pos[ac[av_idx]]
        else:
            av_idx = np.zeros(0, np.int64)
            av_tgt = np.zeros(0, np.int64)

        buckets.append(BlockBucket(
            k=k, N=N, cols=cols_b,
            a_rows=a_row[amask], a_pi=a_pi[amask], a_pj=a_pj[amask], a_tgt=tgt,
            p_idx=np.nonzero(pmask)[0], p_tgt=ptgt, **target_stream(tgt, ptgt),
            R=R, row_ids=row_ids, av_idx=av_idx, av_tgt=av_tgt,
        ))
    return BlockKKTMeta(n=int(n), buckets=tuple(buckets))


def meta_to_device(meta: BlockKKTMeta, device) -> BlockKKTMeta:
    """The index maps of ``meta`` as int64 tensors on ``device``."""
    def move(b):
        return dataclasses.replace(b, **{
            f.name: to_device(getattr(b, f.name), device, torch.float64)
            for f in dataclasses.fields(b)
        })

    return dataclasses.replace(meta, buckets=tuple(move(b) for b in meta.buckets))


# ----------------------------------------------------------------------
# numeric phase on the device
# ----------------------------------------------------------------------

def _ext0(v):
    return torch.cat([v, v.new_zeros(1)])


def factor(meta: BlockKKTMeta, P, A, sigma, rho_vec, build_pair: bool = False,
           a_vals=None):
    """Assemble the component blocks of M and cache their inverses — the
    analog of the reference's ``update_rho!`` refactorization
    (kktsolver.jl:118-124). ``P`` and ``A`` are :class:`~.linops.Coo`.

    State per bucket: ``(Minv [N, k, k], Ad [N, R, k] or None, rhog [N, R]
    or None)`` — the inverses, the block-dense A and the rho of its rows.
    ``build_pair`` also assembles the blocks as double-f32 pairs (error-free
    products A_i A_j rho, reduced per target by the compensated segment
    sum), so Mh + Ml is M to ~eps^2 — the state is then ``(Minv, Mh, Ml,
    Ad, rhog)``. A block without a Cholesky factor gets a NaN inverse, as
    JAX's ``cholesky`` gives, so the solve ends Unsolved instead of raising.

    Under a mesh each bucket holds the rank's own components and their pair
    lists (``parallel.shard_blockkkt``), which index A's row-sorted values
    in full: ``a_vals``, :func:`~.linops.full_vals` of ``A``, which a solve
    gathers once for all its factorizations (gathered here when not given).
    The blocks are then summed in a fixed order (``linops._segment_sum``).
    """
    dtype = A.vals.dtype
    vals = full_vals(A) if a_vals is None else a_vals
    fixed = meta.shard is not None
    states = []
    for b in meta.buckets:
        # sigma on real diagonals; 1 on padded slots so the factorization
        # stays nonsingular (and the pad solves to 0)
        diag_add = torch.where(b.cols == meta.n, torch.ones((), dtype=dtype,
                                                           device=b.cols.device),
                               sigma)
        if build_pair:
            a_hi, a_e = df32.two_prod(vals[b.a_pi], vals[b.a_pj])
            rho_g = rho_vec[b.a_rows]
            m_hi, m_e1 = df32.two_prod(a_hi, rho_g)
            m_e = m_e1 + a_e * rho_g
            stream_h = torch.cat([m_hi, P.vals[b.p_idx]])[b.m_perm]
            stream_e = torch.cat([m_e, m_e.new_zeros(b.p_idx.numel())])[b.m_perm]
            hi, lo = df32._segment_sum_df32(stream_h, stream_e, b.m_ptr, b.m_width)
            Mh = vals.new_zeros(b.N * b.k * b.k)
            Ml = vals.new_zeros(b.N * b.k * b.k)
            Mh[b.m_uniq] = hi
            Ml[b.m_uniq] = lo
            Mh = Mh.reshape(b.N, b.k, b.k)
            Ml = Ml.reshape(b.N, b.k, b.k)
            ar = torch.arange(b.k, device=b.cols.device)
            dh, de = df32.two_sum(Mh[:, ar, ar], diag_add)
            Mh[:, ar, ar] = dh
            Ml[:, ar, ar] += de
            M = Mh
        else:
            Mflat = _segment_sum(
                torch.cat([P.vals[b.p_idx], vals[b.a_pi] * vals[b.a_pj] * rho_vec[b.a_rows]]),
                torch.cat([b.p_tgt, b.a_tgt]), b.N * b.k * b.k, fixed)
            M = Mflat.reshape(b.N, b.k, b.k) + torch.diag_embed(diag_add)
        L, info = torch.linalg.cholesky_ex(M)
        L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
        eye = torch.eye(b.k, dtype=dtype, device=M.device).expand(b.N, b.k, b.k)
        # the explicit inverse: the per-iteration apply is one batched
        # [N, k, k] @ [N, k] product instead of two triangular solves
        Minv = torch.cholesky_solve(eye, L)
        Ad = rhog = None
        if b.row_ids is not None:
            Ad = A.vals.new_zeros(b.N * b.R * b.k)
            Ad[b.av_tgt] = A.vals[b.av_idx]
            Ad = Ad.reshape(b.N, b.R, b.k)
            # rho of the component rows, cached per factor (rho only
            # changes at a refactor)
            rhog = _ext0(rho_vec)[b.row_ids]
        states.append((Minv, Mh, Ml, Ad, rhog) if build_pair else (Minv, Ad, rhog))
    return tuple(states)


def _has_pair(state) -> bool:
    return len(state) > 0 and len(state[0]) == 5


def _apply(meta: BlockKKTMeta, state, t):
    """M^-1 t through the cached block inverses (reassembled over a mesh)."""
    tp = _ext0(t)
    out = t.new_zeros(meta.n + 1)
    for b, st in zip(meta.buckets, state):
        xb = torch.einsum("nij,nj->ni", st[0], tp[b.cols])
        out[b.cols.reshape(-1)] = xb.reshape(-1)
    return reduce_sum(meta.shard, out[:-1])


def _block_matvec(meta: BlockKKTMeta, state, x, m: int):
    """A @ x via the cached block-dense A (one batched einsum per bucket)."""
    xp = _ext0(x)
    out = x.new_zeros(m + 1)
    for b, st in zip(meta.buckets, state):
        yb = torch.einsum("nrk,nk->nr", st[-2], xp[b.cols])
        out[b.row_ids.reshape(-1)] = yb.reshape(-1)
    return out[:-1]


def _block_rmatvec(meta: BlockKKTMeta, state, y):
    """A' @ y via the cached block-dense A."""
    yp = _ext0(y)
    out = y.new_zeros(meta.n + 1)
    for b, st in zip(meta.buckets, state):
        xb = torch.einsum("nrk,nr->nk", st[-2], yp[b.row_ids])
        out[b.cols.reshape(-1)] = xb.reshape(-1)
    return out[:-1]


def _matvec_pair(meta: BlockKKTMeta, state, x_pair):
    """Compensated M @ x from the pair-valued blocks: a batched [N, k, k]
    elementwise product and pairwise two_sum reduction per bucket."""
    xh_e, xl_e = _ext0(x_pair[0]), _ext0(x_pair[1])
    outh = xh_e.new_zeros(meta.n + 1)
    outl = xh_e.new_zeros(meta.n + 1)
    for b, st in zip(meta.buckets, state):
        hi, lo = _pair_block_matvec(st[1], st[2], xh_e[b.cols], xl_e[b.cols])
        flat = b.cols.reshape(-1)
        outh[flat] = hi.reshape(-1)
        outl[flat] = lo.reshape(-1)
    return df32.reduce_pair(meta.shard, outh[:-1], outl[:-1])


def _pair_block_matvec(Mh, Ml, xh, xl):
    """(Mh + Ml) @ (xh + xl) per block in double-f32: [N, k] pairs."""
    Xh, Xl = xh[:, None, :], xl[:, None, :]
    p, e = df32.two_prod(Mh, Xh)
    e = e + Mh * Xl + Ml * Xh
    return df32._pairwise_sum(p, e, 2)


def _block_rhs_pair(Ad, rhog, r2g, r1b):
    """Compensated t = r1 + A'(rho r2) of one bucket: [N, k] pairs."""
    ph, pl = df32.two_prod(rhog, r2g)
    p, e = df32.two_prod(Ad, ph[:, :, None])
    e = e + Ad * pl[:, :, None]
    hi, lo = df32._pairwise_sum(p.transpose(1, 2), e.transpose(1, 2), 2)
    return df32.add((hi, lo), df32.promote(r1b))


def _refine_block(Minv, Mh, Ml, t_pair, refine_steps: int):
    """x = M^-1 t of one bucket with ``refine_steps`` corrections whose
    residual t - M x is measured in double-f32 against (Mh, Ml)."""
    xp = df32.promote(torch.einsum("nij,nj->ni", Minv, t_pair[0]))
    for _ in range(refine_steps):
        mh, ml = _pair_block_matvec(Mh, Ml, xp[0], xp[1])
        rr = df32.to_f32(df32.add(t_pair, (-mh, -ml)))
        xp = df32.add(xp, df32.promote(torch.einsum("nij,nj->ni", Minv, rr)))
    return df32.to_f32(xp)


def _block_rhs2(meta: BlockKKTMeta, state, rho_vec, r1, r2):
    """Compensated t = r1 + A'(rho r2) in n-space via the block-dense A
    (:func:`_block_rhs_pair` per bucket, with the rho of ``rho_vec``)."""
    rho_e, r2_e, r1p = _ext0(rho_vec), _ext0(r2), _ext0(r1)
    outh = r1.new_zeros(meta.n + 1)
    outl = r1.new_zeros(meta.n + 1)
    for b, st in zip(meta.buckets, state):
        hi, lo = _block_rhs_pair(st[-2], rho_e[b.row_ids], r2_e[b.row_ids], r1p[b.cols])
        flat = b.cols.reshape(-1)
        outh[flat] = hi.reshape(-1)
        outl[flat] = lo.reshape(-1)
    return outh[:-1], outl[:-1]


def _solve_fused(meta: BlockKKTMeta, state, rho_vec, r1, r2):
    """The solve with the whole t -> x -> nu chain kept per bucket:
    components have disjoint rows and columns, so each bucket gathers its
    inputs once, runs the batched einsums and scatters x and nu once."""
    m = r2.shape[0]
    r1p, r2p = _ext0(r1), _ext0(r2)
    x_out = r1.new_zeros(meta.n + 1)
    # rows no component covers (all-zero A rows, e.g. the compact
    # transform's pad rows) see Ax = 0
    nu_out = _ext0(rho_vec * (0.0 - r2))
    for b, st in zip(meta.buckets, state):
        Minv, Ad, rhog = st[0], st[-2], st[-1]
        r2g = r2p[b.row_ids]
        tb = r1p[b.cols] + torch.einsum("nrk,nr->nk", Ad, rhog * r2g)
        xb = torch.einsum("nij,nj->ni", Minv, tb)
        nub = rhog * (torch.einsum("nrk,nk->nr", Ad, xb) - r2g)
        x_out[b.cols.reshape(-1)] = xb.reshape(-1)
        nu_out[b.row_ids.reshape(-1)] = nub.reshape(-1)
    return x_out[: meta.n], nu_out[:m]


def _solve_fused_refined(meta: BlockKKTMeta, state, rho_vec, r1, r2,
                         refine_steps: int):
    """The refined solve with the compensated right-hand side, the apply
    and the pair-matvec refinement kept per bucket (the disjoint rows and
    columns argument of :func:`_solve_fused`); needs the pair-valued state
    of ``factor(build_pair=True)``."""
    m = r2.shape[0]
    r1p, r2p = _ext0(r1), _ext0(r2)
    x_out = r1.new_zeros(meta.n + 1)
    nu_out = _ext0(rho_vec * (0.0 - r2))
    for b, (Minv, Mh, Ml, Ad, rhog) in zip(meta.buckets, state):
        r2g = r2p[b.row_ids]
        t_pair = _block_rhs_pair(Ad, rhog, r2g, r1p[b.cols])
        xb = _refine_block(Minv, Mh, Ml, t_pair, refine_steps)
        nub = rhog * (torch.einsum("nrk,nk->nr", Ad, xb) - r2g)
        x_out[b.cols.reshape(-1)] = xb.reshape(-1)
        nu_out[b.row_ids.reshape(-1)] = nub.reshape(-1)
    return x_out[: meta.n], nu_out[:m]


def supports_blockspace(meta) -> bool:
    """True when every bucket carries the block-dense A — the precondition
    of the block-space x carry (:func:`solve_blockspace`); never under a
    mesh."""
    return (meta is not None and meta.shard is None and len(meta.buckets) > 0
            and all(b.row_ids is not None for b in meta.buckets))


def blockspace_cols(meta: BlockKKTMeta):
    """The concatenated member-column map [sum(N_b k_b)] over all buckets
    (pad slots == n): the permutation, padded, between the n-space x and
    its block-space layout. Components partition the columns, so every
    column appears exactly once."""
    return torch.cat([b.cols.reshape(-1) for b in meta.buckets])


def blockspace_dim(meta: BlockKKTMeta) -> int:
    """Length of the block-space x layout (sum of N_b k_b)."""
    return int(sum(b.N * b.k for b in meta.buckets))


def solve_blockspace(meta: BlockKKTMeta, state, rho_vec, r1g, r2,
                     refine_steps: int = 0):
    """:func:`_solve_fused` with x kept in the block-space layout: ``r1g``
    is r1 in that layout and the returned x is too, so the per-iteration
    column gather and x scatter become slices. ``refine_steps`` > 0 with a
    pair-valued state runs the refined chain of :func:`_solve_fused_refined`
    per bucket. Returns ``(xg, nu)``."""
    m = r2.shape[0]
    r2p = _ext0(r2)
    nu_out = _ext0(rho_vec * (0.0 - r2))
    refine = refine_steps > 0 and _has_pair(state)
    xs = []
    off = 0
    for b, st in zip(meta.buckets, state):
        Minv, Ad, rhog = st[0], st[-2], st[-1]
        r2g = r2p[b.row_ids]
        r1b = r1g[off: off + b.N * b.k].reshape(b.N, b.k)
        off += b.N * b.k
        if refine:
            xb = _refine_block(Minv, st[1], st[2],
                               _block_rhs_pair(Ad, rhog, r2g, r1b), refine_steps)
        else:
            tb = r1b + torch.einsum("nrk,nr->nk", Ad, rhog * r2g)
            xb = torch.einsum("nij,nj->ni", Minv, tb)
        nub = rhog * (torch.einsum("nrk,nk->nr", Ad, xb) - r2g)
        xs.append(xb.reshape(-1))
        nu_out[b.row_ids.reshape(-1)] = nub.reshape(-1)
    return torch.cat(xs), nu_out[:m]


def covered_rows_mask(meta: BlockKKTMeta, m: int):
    """Bool [m+1]: the rows some component covers (loop-invariant: build it
    once per solve for :func:`compensated_residuals`)."""
    covered = torch.zeros(m + 1, dtype=torch.bool, device=meta.buckets[0].cols.device)
    for b in meta.buckets:
        covered[b.row_ids.reshape(-1)] = True
    return covered


def compensated_residuals(meta: BlockKKTMeta, state, xg, s, mu, bv, qg,
                          Einv, Dg, cinv, Px_pair_g=None, covered=None):
    """Termination/rho residuals (rp, rd, mp, md) of the problem in
    double-f32 through the block-dense A: every A row lies inside one
    component, so the compensated products are batched [N, R, k] passes on
    the cached Ad and one rows gather (cosmo_tpu.ops.blockkkt). The
    definitions are those of ops/residuals.py.

    ``xg``/``qg`` are in the block-space layout; ``Einv`` is the m-vector
    row scaling (ones when unscaled); ``Dg`` the column scaling in block
    space with zero pad slots (they mask the pad columns); ``Px_pair_g`` an
    optional compensated P x in block space (None when P has no entries).
    """
    m = s.shape[0]
    sb_ext, mu_ext = _ext0(s - bv), _ext0(mu)
    E_ext = _ext0(Einv)                      # pad slot 0 masks pad rows
    if covered is None:
        covered = covered_rows_mask(meta, m)
    rp_cov = xg.new_zeros(())
    mp_ax = xg.new_zeros(())
    at_h, at_l = [], []
    off = 0
    for b, st in zip(meta.buckets, state):
        Ad = st[-2]
        rows = b.row_ids
        xb = xg[off: off + b.N * b.k].reshape(b.N, b.k)
        off += b.N * b.k
        # compensated (A x) at the covered rows: [N, R]
        p, e = df32.two_prod(Ad, xb[:, None, :])
        axh, axl = df32._pairwise_sum(p, e, 2)
        Er = E_ext[rows]
        rph, rpl = df32.add((axh, axl), df32.promote(sb_ext[rows]))
        rp_cov = torch.maximum(rp_cov, (Er * df32.to_f32((rph, rpl))).abs().max())
        mp_ax = torch.maximum(mp_ax, (Er * df32.to_f32((axh, axl))).abs().max())
        # compensated (A' mu) in block space: [N, k]
        p2, e2 = df32.two_prod(Ad, mu_ext[rows][:, :, None])
        h2, l2 = df32._pairwise_sum(p2.transpose(1, 2), e2.transpose(1, 2), 2)
        at_h.append(h2.reshape(-1))
        at_l.append(l2.reshape(-1))
    ath, atl = torch.cat(at_h), torch.cat(at_l)
    # uncovered rows have structurally zero A rows: r_prim there is s - b
    zero = xg.new_zeros(())
    rp_unc = torch.where(covered[:-1], zero, (Einv * sb_ext[:-1]).abs()).max()
    rp = torch.maximum(rp_cov, rp_unc)
    mp = torch.maximum(mp_ax, torch.maximum((Einv * s).abs().max(),
                                            (Einv * bv).abs().max()))
    if Px_pair_g is None:
        ph, pl = torch.zeros_like(qg), torch.zeros_like(qg)
    else:
        ph, pl = Px_pair_g
    dh, dl = df32.add((ph, pl), df32.promote(qg))
    dh, dl = df32.add((dh, dl), (-ath, -atl))
    rd = cinv * (Dg * df32.to_f32((dh, dl))).abs().max()
    md = cinv * torch.maximum(
        (Dg * df32.to_f32((ph, pl))).abs().max(),
        torch.maximum((Dg * qg).abs().max(),
                      (Dg * df32.to_f32((ath, atl))).abs().max()))
    return rp, rd, mp, md


def solve(meta: BlockKKTMeta, state, P, A, sigma, rho_vec, r1, r2,
          refine_steps: int = 0):
    """Solve the KKT system through the cached block inverses. Returns
    ``(x_tilde, nu)``. ``rho_vec`` must be the vector ``state`` was factored
    with (the fused path reads the factor-time rho of the covered rows).
    ``refine_steps`` > 0 refines with double-f32 residuals: through the
    pair-valued blocks when ``state`` has them, else through the global
    compensated COO passes of ops/df32.py."""
    use_block_A = len(state) > 0 and all(st[-2] is not None for st in state)
    m = r2.shape[0]
    if refine_steps <= 0:
        if use_block_A:
            return _solve_fused(meta, state, rho_vec, r1, r2)
        x = _apply(meta, state, r1 + rmatvec(A, rho_vec * r2))
    else:
        if use_block_A and _has_pair(state):
            return _solve_fused_refined(meta, state, rho_vec, r1, r2, refine_steps)
        if use_block_A:
            t_pair = _block_rhs2(meta, state, rho_vec, r1, r2)
        else:
            t_pair = df32.kkt_rhs2(A, rho_vec, r1, r2)
        x_pair = df32.promote(_apply(meta, state, t_pair[0]))
        for _ in range(refine_steps):
            if _has_pair(state):
                mh, ml = _matvec_pair(meta, state, x_pair)
                r = df32.to_f32(df32.add(t_pair, (-mh, -ml)))
            else:
                r = df32.kkt_residual_pair(P, A, sigma, rho_vec, t_pair, x_pair)
            x_pair = df32.add(x_pair, df32.promote(_apply(meta, state, r)))
        x = df32.to_f32(x_pair)
    if use_block_A:
        return x, rho_vec * (_block_matvec(meta, state, x, m) - r2)
    return x, rho_vec * (matvec(A, x) - r2)
