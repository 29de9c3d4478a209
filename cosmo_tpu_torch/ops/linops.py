"""Linear-operator layer: dense, COO or block-dense-row matrices on the
device (the port of ``cosmo_tpu.ops.linops``).

Every consumer (Ruiz scaling, the KKT solves, residuals, certificates) goes
through one interface over

* a dense ``torch.Tensor`` [m, n];
* :class:`Coo` — the triplets twice, sorted by row (for ``A @ x``) and by
  column (for ``A.T @ y``); a matvec is a gather, a product and a sum per
  sorted segment (:func:`_coo_segment_sum`). The decomposed problems and
  other sparse input hold P and A this way;
* :class:`Bde` — G contiguous groups of ``rb`` rows, each over at most
  ``cmax`` columns (one PSD block of a block-structured SDP per group), so
  a matvec is one small column selection plus a batched [rb, cmax] product.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Coo:
    """COO sparse matrix with row-sorted and column-sorted copies of its
    triplets (see ``cosmo_tpu.ops.linops.Coo``). The row-sorted order is
    the canonical one of :func:`coo_from_scipy`, which the block KKT's
    nnz-index maps (ops/blockkkt.py) point into. ``row_ptr``/``col_ptr``
    are the CSR/CSC segment pointers into the two copies, with the longest
    segment of each: the compensated double-f32 matvecs (ops/df32.py)
    reduce each row or column as one fixed-width gather."""

    m: int
    n: int
    rows: Any = None    # int [nnz], sorted ascending
    cols: Any = None    # int [nnz]
    vals: Any = None    # [nnz]
    crows: Any = None   # int [nnz] (column-sorted copy)
    ccols: Any = None   # int [nnz], sorted ascending
    cvals: Any = None   # [nnz]
    row_ptr: Any = None  # int [m+1] segment starts in the row-sorted copy
    col_ptr: Any = None  # int [n+1] segment starts in the column-sorted copy
    max_row_nnz: int = 0
    max_col_nnz: int = 0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.vals.dtype


def coo_from_scipy(A, dtype=np.float64) -> Coo:
    """A host-side (numpy) :class:`Coo` from a scipy sparse matrix; move it
    to a device with :func:`coo_to_device`."""
    import scipy.sparse as sp

    Ac = sp.coo_matrix(A)
    m, n = Ac.shape
    r = np.asarray(Ac.row, dtype=np.int64)
    c = np.asarray(Ac.col, dtype=np.int64)
    v = np.asarray(Ac.data, dtype=dtype)
    pr = np.lexsort((c, r))
    pc = np.lexsort((r, c))
    row_ptr, w_r = segment_ptr(r[pr], m)
    col_ptr, w_c = segment_ptr(c[pc], n)
    return Coo(m=m, n=n, rows=r[pr], cols=c[pr], vals=v[pr],
               crows=r[pc], ccols=c[pc], cvals=v[pc],
               row_ptr=row_ptr, col_ptr=col_ptr, max_row_nnz=w_r, max_col_nnz=w_c)


def coo_to_device(A: Coo, device, dtype: torch.dtype) -> Coo:
    return dataclasses.replace(A, **{
        f.name: to_device(getattr(A, f.name), device, dtype)
        for f in dataclasses.fields(A)
    })


@dataclasses.dataclass(frozen=True)
class Bde:
    """Block-dense rows (see ``cosmo_tpu.ops.linops.Bde``).

    ``cols`` is padded with the dump column ``n``: reads through it see 0
    and writes to it land in a slot that is sliced off. ``ell_idx[j, l]``
    indexes the flat [G*cmax] per-column partials (the appended slot
    G*cmax reads 0) for the transpose reduction; ``sel`` is the one-hot
    [G*cmax, n] selection panel that replaces both gathers when it fits the
    memory budget.
    """

    m: int
    n: int
    rb: int
    cmax: int
    vals: Any = None            # [G, rb, cmax]
    vals_t: Any = None          # [G, cmax, rb]
    cols: Any = None            # int [G, cmax], dump = n
    ccols_sorted: Any = None    # int [G*cmax] sorted ascending
    csort_perm: Any = None      # int [G*cmax] into (g*cmax + c)
    col_ptr: Any = None         # int [n+2]
    max_col_nnz: int = 0
    ell_idx: Any = None         # int [n, max col count]
    sel: Any = None             # [G*cmax, n] or None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def G(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype


def segment_ptr(sorted_ids: np.ndarray, num_segments: int):
    """CSR-style pointer array for a sorted segment-id array (host side).
    Returns (ptr [num_segments+1] int32, max segment width)."""
    counts = np.bincount(sorted_ids, minlength=num_segments)
    ptr = np.zeros(num_segments + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    return ptr, int(counts.max()) if counts.size else 0


def bde_from_scipy(A, rb: int, max_cmax: int | None = None,
                   sel_budget_bytes: int = 64 << 20) -> "Bde | None":
    """Build a host-side (numpy) :class:`Bde` from a scipy sparse matrix
    whose rows decompose into ``m / rb`` contiguous groups. Returns None
    when ``rb`` does not divide m or a group touches more than ``max_cmax``
    columns (default ``n // 4``). Move it to a device with
    :func:`bde_to_device`."""
    import scipy.sparse as sp

    Ac = sp.csr_matrix(A)
    m, n = Ac.shape
    if rb <= 0 or m % rb != 0:
        return None
    G = m // rb
    indptr, indices, data = Ac.indptr, Ac.indices, Ac.data
    col_lists = []
    cmax = 0
    for g in range(G):
        s, e = indptr[g * rb], indptr[(g + 1) * rb]
        u = np.unique(indices[s:e])
        col_lists.append(u)
        cmax = max(cmax, u.size)
    if cmax == 0:
        cmax = 1
    limit = max_cmax if max_cmax is not None else max(1, n // 4)
    if cmax > limit:
        return None
    cols = np.full((G, cmax), n, dtype=np.int32)
    vals = np.zeros((G, rb, cmax), dtype=data.dtype if data.size else np.float64)
    for g, u in enumerate(col_lists):
        cols[g, : u.size] = u
        vals[g, :, : u.size] = Ac[g * rb : (g + 1) * rb, :][:, u].toarray()
    flat_cols = cols.reshape(-1)
    perm = np.argsort(flat_cols, kind="stable").astype(np.int32)
    scols = flat_cols[perm]
    col_ptr, w_c = segment_ptr(scols, n + 1)
    w = max(int(np.max(col_ptr[1 : n + 1] - col_ptr[:n])) if n else 0, 1)
    ell = np.full((n, w), G * cmax, dtype=np.int32)
    for j in range(n):
        s, e = col_ptr[j], col_ptr[j + 1]
        ell[j, : e - s] = perm[s:e]
    sel = None
    if G * cmax * n * vals.itemsize <= sel_budget_bytes:
        sel = np.zeros((G * cmax, n), dtype=vals.dtype)
        valid = flat_cols < n
        sel[np.flatnonzero(valid), flat_cols[valid]] = 1.0
    return Bde(
        m=m, n=n, rb=rb, cmax=cmax,
        vals=vals, vals_t=np.ascontiguousarray(np.swapaxes(vals, 1, 2)),
        cols=cols,
        ccols_sorted=scols.astype(np.int32),
        csort_perm=perm, col_ptr=col_ptr, max_col_nnz=w_c,
        ell_idx=ell, sel=sel,
    )


def to_device(x, device, dtype: torch.dtype):
    """numpy array -> a new tensor on ``device``: floating arrays in
    ``dtype``, integer arrays as int64 (torch's index type), bools as bool.
    Tensors and non-arrays pass through (tensors moved to ``device``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if not isinstance(x, np.ndarray):
        return x
    if np.issubdtype(x.dtype, np.floating):
        return torch.tensor(x, dtype=dtype, device=device)
    if x.dtype == np.bool_:
        return torch.tensor(x, dtype=torch.bool, device=device)
    return torch.tensor(x.astype(np.int64), device=device)


def bde_to_device(A: Bde, device, dtype: torch.dtype) -> Bde:
    return dataclasses.replace(A, **{
        f.name: to_device(getattr(A, f.name), device, dtype)
        for f in dataclasses.fields(A)
    })


def _ext0(x):
    """x with one appended zero (the Bde dump-column read slot)."""
    return torch.cat([x, x.new_zeros(1)])


# ----------------------------------------------------------------------
# matvecs
# ----------------------------------------------------------------------

def _segment_sum(vals, ids, num: int):
    return vals.new_zeros(num).index_add_(0, ids, vals)


def _segment_amax(vals, ids, num: int):
    """max per segment, 0 for an empty one (the values are >= 0)."""
    return vals.new_zeros(num).scatter_reduce_(0, ids, vals, "amax")


# a Coo copy whose widest segment has this many entries or more sums its
# segments with torch.segment_reduce, else with index_add_ (measured on an
# H100 by profile_cg.py on the same inputs: index_add_ 4.5-21 times faster
# on the banded and maxcut A (widest 2-10; segment_reduce's cost grows with
# the segment count), even at the portfolio's A'y (widest 128),
# segment_reduce 15 times faster on its A x (widest 20,000), where
# index_add_'s float atomics serialize on each row)
SEGMENT_REDUCE_WIDTH = 128


def _coo_segment_sum(prod, ids, ptr, num: int, widest: int):
    """The sum of each of the ``num`` segments of ``prod``, a sorted copy's
    products (the reference's ``segment_sum``): ``index_add_`` over the
    sorted ``ids``, or ``torch.segment_reduce`` over the pointers ``ptr``
    where the ``widest`` segment reaches ``SEGMENT_REDUCE_WIDTH``. Both
    give the same bits on the CPU; ``segment_reduce`` has no atomics, so on
    a CUDA device its bits are the same on every run."""
    if widest >= SEGMENT_REDUCE_WIDTH:
        return torch.segment_reduce(prod, "sum", offsets=ptr, unsafe=True)
    return _segment_sum(prod, ids, num)


def matvec(A, x):
    """A @ x."""
    if isinstance(A, Coo):
        return _coo_segment_sum(A.vals * x[A.cols], A.rows, A.row_ptr, A.m, A.max_row_nnz)
    if isinstance(A, Bde):
        if A.sel is not None:
            xg = (A.sel @ x).reshape(A.G, A.cmax)
        else:
            xg = _ext0(x)[A.cols]                   # [G, cmax]
        return torch.einsum("grc,gc->gr", A.vals, xg).reshape(A.m)
    return A @ x


def rmatvec(A, y):
    """A.T @ y."""
    if isinstance(A, Coo):
        return _coo_segment_sum(A.cvals * y[A.crows], A.ccols, A.col_ptr, A.n,
                                A.max_col_nnz)
    if isinstance(A, Bde):
        t = torch.einsum("gcr,gr->gc", A.vals_t, y.reshape(A.G, A.rb))
        if A.sel is not None:
            return t.reshape(-1) @ A.sel
        return _ext0(t.reshape(-1))[A.ell_idx].sum(dim=1)
    return A.T @ y


# ----------------------------------------------------------------------
# reductions / scalings used by Ruiz equilibration and the dense KKT
# ----------------------------------------------------------------------

def colmax_abs(A):
    """max_i |A_ij| per column j (0 for empty columns)."""
    if isinstance(A, Coo):
        return _segment_amax(A.cvals.abs(), A.ccols, A.n)
    if isinstance(A, Bde):
        t = A.vals.abs().amax(dim=1)                # [G, cmax]
        return _ext0(t.reshape(-1))[A.ell_idx].amax(dim=1)
    if A.shape[0] == 0:
        return A.new_zeros(A.shape[1])
    return A.abs().amax(dim=0)


def rowmax_abs(A):
    """max_j |A_ij| per row i (0 for empty rows)."""
    if isinstance(A, Coo):
        return _segment_amax(A.vals.abs(), A.rows, A.m)
    if isinstance(A, Bde):
        return A.vals.abs().amax(dim=2).reshape(A.m)
    if A.shape[1] == 0:
        return A.new_zeros(A.shape[0])
    return A.abs().amax(dim=1)


def scale_rows_cols(A, ew, dw):
    """E A D with diagonal row scaling ew and column scaling dw."""
    if isinstance(A, Coo):
        return dataclasses.replace(
            A,
            vals=A.vals * ew[A.rows] * dw[A.cols],
            cvals=A.cvals * ew[A.crows] * dw[A.ccols],
        )
    if isinstance(A, Bde):
        ewg = ew.reshape(A.G, A.rb)
        dwg = _ext0(dw)[A.cols]
        return dataclasses.replace(
            A,
            vals=A.vals * ewg[:, :, None] * dwg[:, None, :],
            vals_t=A.vals_t * ewg[:, None, :] * dwg[:, :, None],
        )
    return ew[:, None] * A * dw[None, :]


def scale_rows(A, ew):
    if isinstance(A, Coo):
        return dataclasses.replace(
            A, vals=A.vals * ew[A.rows], cvals=A.cvals * ew[A.crows])
    if isinstance(A, Bde):
        ewg = ew.reshape(A.G, A.rb)
        return dataclasses.replace(
            A, vals=A.vals * ewg[:, :, None], vals_t=A.vals_t * ewg[:, None, :]
        )
    return ew[:, None] * A


def scale_all(A, c):
    """c * A with a scalar c."""
    if isinstance(A, Coo):
        return dataclasses.replace(A, vals=A.vals * c, cvals=A.cvals * c)
    if isinstance(A, Bde):
        return dataclasses.replace(A, vals=A.vals * c, vals_t=A.vals_t * c)
    return A * c


def symmetrize(P):
    """(P + P') / 2; a Coo is taken as symmetric already (the symmetric
    Ruiz scaling keeps it so)."""
    if isinstance(P, Coo):
        return P
    return 0.5 * (P + P.T)


def diag_part(P):
    """diag(P) as a vector."""
    if isinstance(P, Coo):
        on_diag = P.rows == P.cols
        return _coo_segment_sum(torch.where(on_diag, P.vals, torch.zeros_like(P.vals)),
                                P.rows, P.row_ptr, P.m, P.max_row_nnz)
    return torch.diagonal(P)


def diag_AtRhoA(A, rho_vec):
    """diag(A' diag(rho) A) = sum_i rho_i A_ij^2 per column j."""
    if isinstance(A, Coo):
        return _coo_segment_sum(rho_vec[A.crows] * A.cvals * A.cvals, A.ccols, A.col_ptr,
                                A.n, A.max_col_nnz)
    if isinstance(A, Bde):
        t = torch.einsum("grc,gr,grc->gc", A.vals, rho_vec.reshape(A.G, A.rb),
                         A.vals)
        return _ext0(t.reshape(-1))[A.ell_idx].sum(dim=1)
    return (rho_vec[:, None] * A * A).sum(dim=0)


def AtRhoA(A, rho_vec):
    """Dense n x n assembly of A' diag(rho) A, the Gram matrix the dense KKT
    factors. For :class:`Bde`: G batched [cmax, cmax] Gram blocks
    scatter-added into the dense panel."""
    if isinstance(A, Bde):
        C = torch.einsum(
            "grc,gr,grd->gcd", A.vals, rho_vec.reshape(A.G, A.rb), A.vals
        )
        Mext = A.vals.new_zeros((A.n + 1, A.n + 1))
        ci = A.cols[:, :, None].expand(C.shape)
        cj = A.cols[:, None, :].expand(C.shape)
        Mext.index_put_((ci, cj), C, accumulate=True)
        return Mext[: A.n, : A.n]
    if isinstance(A, Coo):
        raise TypeError("the dense KKT takes a dense or Bde A; a Coo A goes "
                        "through the block-diagonal KKT (ops/blockkkt.py)")
    return A.T @ (rho_vec[:, None] * A)
