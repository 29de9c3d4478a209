"""Block-diagonal direct KKT solve for structurally decoupled systems (the
port of ``cosmo_tpu.ops.blockkkt`` without its double-f32 refinement).

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
  batched Cholesky (at setup and on every rho change);
* :func:`solve` / :func:`solve_blockspace` apply them: per bucket one gather
  of the rows, batched einsums through the block-dense A and the cached
  inverses, and one scatter.

There is no hand-written kernel here: the batched Cholesky, triangular
solves and einsums are PyTorch's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .linops import matvec, rmatvec, to_device

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
    cols: Any = None        # int [N, k] member columns (pad = n)
    a_rows: Any = None      # int [nA] row of each A-pair (rho gather)
    a_pi: Any = None        # int [nA] row-sorted nnz index of entry a
    a_pj: Any = None        # int [nA] row-sorted nnz index of entry b
    a_tgt: Any = None       # int [nA] flat target in [N*k*k]
    p_idx: Any = None       # int [nP] row-sorted nnz index into P
    p_tgt: Any = None       # int [nP] flat target in [N*k*k]
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


def _canonical_coo(X):
    """The nnz order of linops.coo_from_scipy (row-major, through csr), so
    the device-side ``vals[idx]`` gathers hit the intended entries."""
    import scipy.sparse as sp

    Xc = sp.coo_matrix(sp.csr_matrix(X))
    r = np.asarray(Xc.row, dtype=np.int64)
    c = np.asarray(Xc.col, dtype=np.int64)
    p = np.lexsort((c, r))
    return r[p], c[p]


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
            p_idx=np.nonzero(pmask)[0], p_tgt=ptgt,
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


def factor(meta: BlockKKTMeta, P, A, sigma, rho_vec):
    """Assemble the component blocks of M and cache their inverses — the
    analog of the reference's ``update_rho!`` refactorization
    (kktsolver.jl:118-124). ``P`` and ``A`` are :class:`~.linops.Coo`.

    State per bucket: ``(Minv [N, k, k], Ad [N, R, k] or None, rhog [N, R]
    or None)`` — the inverses, the block-dense A and the rho of its rows.
    A block without a Cholesky factor gets a NaN inverse, as JAX's
    ``cholesky`` gives, so the solve ends Unsolved instead of raising.
    """
    dtype = A.vals.dtype
    states = []
    for b in meta.buckets:
        # sigma on real diagonals; 1 on padded slots so the factorization
        # stays nonsingular (and the pad solves to 0)
        diag_add = torch.where(b.cols == meta.n, torch.ones((), dtype=dtype,
                                                           device=b.cols.device),
                               sigma)
        Mflat = A.vals.new_zeros(b.N * b.k * b.k)
        if b.p_idx.numel():
            Mflat.index_add_(0, b.p_tgt, P.vals[b.p_idx])
        if b.a_pi.numel():
            Mflat.index_add_(0, b.a_tgt,
                             A.vals[b.a_pi] * A.vals[b.a_pj] * rho_vec[b.a_rows])
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
        states.append((Minv, Ad, rhog))
    return tuple(states)


def _apply(meta: BlockKKTMeta, state, t):
    """M^-1 t through the cached block inverses."""
    tp = _ext0(t)
    out = t.new_zeros(meta.n + 1)
    for b, (Minv, _, _) in zip(meta.buckets, state):
        xb = torch.einsum("nij,nj->ni", Minv, tp[b.cols])
        out[b.cols.reshape(-1)] = xb.reshape(-1)
    return out[:-1]


def _block_matvec(meta: BlockKKTMeta, state, x, m: int):
    """A @ x via the cached block-dense A (one batched einsum per bucket)."""
    xp = _ext0(x)
    out = x.new_zeros(m + 1)
    for b, (_, Ad, _) in zip(meta.buckets, state):
        yb = torch.einsum("nrk,nk->nr", Ad, xp[b.cols])
        out[b.row_ids.reshape(-1)] = yb.reshape(-1)
    return out[:-1]


def _block_rmatvec(meta: BlockKKTMeta, state, y):
    """A' @ y via the cached block-dense A."""
    yp = _ext0(y)
    out = y.new_zeros(meta.n + 1)
    for b, (_, Ad, _) in zip(meta.buckets, state):
        xb = torch.einsum("nrk,nr->nk", Ad, yp[b.row_ids])
        out[b.cols.reshape(-1)] = xb.reshape(-1)
    return out[:-1]


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
    for b, (Minv, Ad, rhog) in zip(meta.buckets, state):
        r2g = r2p[b.row_ids]
        tb = r1p[b.cols] + torch.einsum("nrk,nr->nk", Ad, rhog * r2g)
        xb = torch.einsum("nij,nj->ni", Minv, tb)
        nub = rhog * (torch.einsum("nrk,nk->nr", Ad, xb) - r2g)
        x_out[b.cols.reshape(-1)] = xb.reshape(-1)
        nu_out[b.row_ids.reshape(-1)] = nub.reshape(-1)
    return x_out[: meta.n], nu_out[:m]


def supports_blockspace(meta) -> bool:
    """True when every bucket carries the block-dense A — the precondition
    of the block-space x carry (:func:`solve_blockspace`)."""
    return (meta is not None and len(meta.buckets) > 0
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


def solve_blockspace(meta: BlockKKTMeta, state, rho_vec, r1g, r2):
    """:func:`_solve_fused` with x kept in the block-space layout: ``r1g``
    is r1 in that layout and the returned x is too, so the per-iteration
    column gather and x scatter become slices. Returns ``(xg, nu)``."""
    m = r2.shape[0]
    r2p = _ext0(r2)
    nu_out = _ext0(rho_vec * (0.0 - r2))
    xs = []
    off = 0
    for b, (Minv, Ad, rhog) in zip(meta.buckets, state):
        r2g = r2p[b.row_ids]
        r1b = r1g[off: off + b.N * b.k].reshape(b.N, b.k)
        off += b.N * b.k
        tb = r1b + torch.einsum("nrk,nr->nk", Ad, rhog * r2g)
        xb = torch.einsum("nij,nj->ni", Minv, tb)
        nub = rhog * (torch.einsum("nrk,nk->nr", Ad, xb) - r2g)
        xs.append(xb.reshape(-1))
        nu_out[b.row_ids.reshape(-1)] = nub.reshape(-1)
    return torch.cat(xs), nu_out[:m]


def solve(meta: BlockKKTMeta, state, A, rho_vec, r1, r2):
    """Solve the KKT system through the cached block inverses. Returns
    ``(x_tilde, nu)``. ``rho_vec`` must be the vector ``state`` was factored
    with (the fused path reads the factor-time rho of the covered rows)."""
    if all(Ad is not None for _, Ad, _ in state):
        return _solve_fused(meta, state, rho_vec, r1, r2)
    t = r1 + rmatvec(A, rho_vec * r2)
    x = _apply(meta, state, t)
    return x, rho_vec * (matvec(A, x) - r2)
