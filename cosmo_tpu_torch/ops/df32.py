"""Compensated (double-word) float arithmetic for the accuracy-critical
paths (the port of ``cosmo_tpu.ops.df32``).

In float32 the attainable accuracy of the ADMM x-update is bounded by the
forward error of the KKT solve, ~ kappa(M) * eps: with the rho_eq = 1e3 rho
equality weighting, or the overlap rows of a compact decomposition, that is
a 1e-3..1e-4 floor. The cure is mixed-precision iterative refinement with
the high precision emulated by error-free transformations (Knuth's two_sum,
Dekker's two_prod): the KKT residual is computed against the exact stored
P, A, sigma and rho with a (hi, lo) compensation term carried through every
product and reduction, accurate to ~eps^2.

Every operation here is an ordinary elementwise PyTorch op, each its own
kernel, so each rounds once. That is what keeps the transformations exact:
``two_prod`` assumes no fused multiply-add, so nothing here may be fused
(no ``torch.compile``, ``addcmul``, ``baddbmm`` or matmul in a compensated
expression). The pair reductions are explicit pairwise trees, so the error
channel catches every rounding a reduction makes.
"""
from __future__ import annotations

import torch

from .linops import Bde, Coo, _ext0

# Dekker splitting constants: 2^12 + 1 for binary32 (24-bit significand),
# 2^27 + 1 for binary64 (the same code path then stays exact in float64)
_SPLIT_F32 = 4097.0
_SPLIT_F64 = 134217729.0


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker split; no FMA assumed)."""
    p = a * b
    c = _SPLIT_F32 if p.dtype == torch.float32 else _SPLIT_F64
    a1 = c * a
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = c * b
    bh = b1 - (b1 - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(x, y):
    """(hi, lo) + (hi, lo) -> (hi, lo)."""
    s, e = two_sum(x[0], y[0])
    return s, e + x[1] + y[1]


def scale(r, x):
    """Elementwise r * (hi, lo) with a plain vector r."""
    p, e = two_prod(r, x[0])
    return p, e + r * x[1]


def to_f32(x):
    """Collapse a pair to its closest single float."""
    return x[0] + x[1]


def promote(x):
    """Lift a plain vector to a (hi, 0) pair."""
    return x, torch.zeros_like(x)


def _pairwise_sum(p, e, dim):
    """Compensated reduction along ``dim``: an explicit pairwise two_sum
    tree over the axis zero-padded to a power of two, so the error channel
    captures every rounding the reduction makes."""
    p = p.movedim(dim, -1)
    e = e.movedim(dim, -1)
    n = p.shape[-1]
    if n == 0:
        z = p.new_zeros(p.shape[:-1])
        return z, z.clone()
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        p = torch.nn.functional.pad(p, (0, m - n))
        e = torch.nn.functional.pad(e, (0, m - n))
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        s, err = two_sum(p[..., :h], p[..., h:])
        p = s
        e = e[..., :h] + e[..., h:] + err
    return p[..., 0], e[..., 0]


def dot2(a, b):
    """Compensated dot(a, b) -> (hi, lo)."""
    p, e = two_prod(a, b)
    return _pairwise_sum(p, e, -1)


# ----------------------------------------------------------------------
# matvecs against the exact stored problem data
# ----------------------------------------------------------------------

def _segment_sum_df32(p, e, ptr, width: int):
    """Compensated sorted-segment sum through a fixed-width gather: each of
    the ``len(ptr) - 1`` segments of the sorted streams (p, e) is gathered
    into a row of a [segments, width] tile (lanes past the segment's end
    read exact zeros) and reduced with the pairwise tree."""
    num_segments = ptr.shape[0] - 1
    if width == 0 or p.shape[0] == 0:
        z = p.new_zeros(num_segments)
        return z, z.clone()
    starts = ptr[:-1]
    lens = ptr[1:] - starts
    lane = torch.arange(width, dtype=starts.dtype, device=starts.device)
    idx = starts[:, None] + lane[None, :]
    valid = lane[None, :] < lens[:, None]
    idx = torch.clamp(idx, 0, p.shape[0] - 1)
    zero = p.new_zeros(())
    pe = torch.where(valid, p[idx], zero)
    ee = torch.where(valid, e[idx], zero)
    return _pairwise_sum(pe, ee, 1)


def matvec2(A, x_pair):
    """Compensated A @ x for a dense, Coo or Bde A and a (hi, lo) input
    pair. Returns (hi, lo)."""
    xh, xl = x_pair
    if isinstance(A, Coo):
        p, e = two_prod(A.vals, xh[A.cols])
        e = e + A.vals * xl[A.cols]
        return _segment_sum_df32(p, e, A.row_ptr, A.max_row_nnz)
    if isinstance(A, Bde):
        xg = _ext0(xh)[A.cols][:, None, :]           # [G, 1, cmax]
        p, e = two_prod(A.vals, xg)
        e = e + A.vals * _ext0(xl)[A.cols][:, None, :]
        hi, lo = _pairwise_sum(p, e, 2)              # [G, rb] pairs
        return hi.reshape(A.m), lo.reshape(A.m)
    p, e = two_prod(A, xh[None, :])
    e = e + A * xl[None, :]
    return _pairwise_sum(p, e, 1)


def rmatvec2(A, y_pair):
    """Compensated A.T @ y for a dense, Coo or Bde A and a (hi, lo) pair."""
    yh, yl = y_pair
    if isinstance(A, Coo):
        p, e = two_prod(A.cvals, yh[A.crows])
        e = e + A.cvals * yl[A.crows]
        return _segment_sum_df32(p, e, A.col_ptr, A.max_col_nnz)
    if isinstance(A, Bde):
        # per-group compensated row reductions, then a compensated sorted
        # segment sum over the column-sorted (group, lane) entries
        p, e = two_prod(A.vals, yh.reshape(A.G, A.rb, 1))
        e = e + A.vals * yl.reshape(A.G, A.rb, 1)
        hi, lo = _pairwise_sum(p.transpose(1, 2), e.transpose(1, 2), 2)  # [G, cmax]
        sh, sl = _segment_sum_df32(hi.reshape(-1)[A.csort_perm],
                                   lo.reshape(-1)[A.csort_perm],
                                   A.col_ptr, A.max_col_nnz)
        return sh[: A.n], sl[: A.n]
    p, e = two_prod(A.T, yh[None, :])
    e = e + A.T * yl[None, :]
    return _pairwise_sum(p, e, 1)


def kkt_matvec2(P, A, sigma, rho_vec, x):
    """Compensated reduced-KKT matvec (P + sigma I + A' diag(rho) A) @ x
    against the exact stored P / A / rho (the rounded assembled M is never
    formed). ``x`` is a plain vector; returns (hi, lo)."""
    return kkt_matvec2_pair(P, A, sigma, rho_vec, promote(x))


def kkt_matvec2_pair(P, A, sigma, rho_vec, x_pair):
    """As :func:`kkt_matvec2` for a (hi, lo) input pair, so iterative
    refinement can keep its accumulated solution in double-f32."""
    ax = matvec2(A, x_pair)
    atrax = rmatvec2(A, scale(rho_vec, ax))
    px = matvec2(P, x_pair)
    p, e = two_prod(sigma, x_pair[0])
    sx = (p, e + sigma * x_pair[1])
    return add(add(px, sx), atrax)


def kkt_rhs2(A, rho_vec, r1, r2):
    """Compensated t = r1 + A' (rho .* r2) -> (hi, lo)."""
    t = rmatvec2(A, scale(rho_vec, promote(r2)))
    return add(promote(r1), t)


def kkt_residual(P, A, sigma, rho_vec, t_pair, x):
    """Compensated residual t - M x of the reduced KKT system, collapsed to
    one float (the residual is small, so the collapse loses nothing)."""
    mx = kkt_matvec2(P, A, sigma, rho_vec, x)
    return to_f32(add(t_pair, (-mx[0], -mx[1])))


def kkt_residual_pair(P, A, sigma, rho_vec, t_pair, x_pair):
    """Compensated residual t - M x for a pair-valued x, collapsed."""
    mx = kkt_matvec2_pair(P, A, sigma, rho_vec, x_pair)
    return to_f32(add(t_pair, (-mx[0], -mx[1])))
