"""Batched cone projections and membership tests (the port of
``cosmo_tpu.ops.projections``; reference: src/convexset.jl:885-891).

The composite projection is a fixed sequence of batched ops:

1. one elementwise clip covering Zero/Nonnegatives/Box rows,
2. one vectorized SOC projection per SOC bucket,
3. one batched PSD projection per PSD bucket (gather -> project -> scatter).
"""
from __future__ import annotations

import torch

from . import eigh as eigh_mod
from . import jacobi_proj
from .conedata import ConeData, PsdBucket, resolve_eigh_backend


def _ext(v):
    """Append the dump slot (value 0) used by padded gathers/scatters."""
    return torch.cat([v, v.new_zeros(1)])


def _soc_project_bucket(x):
    """Project rows of x [B, d] onto the second-order cone
    (reference: convexset.jl:100-114). Zero-padding is exact."""
    t = x[:, 0]
    xt = x[:, 1:]
    nx = torch.linalg.vector_norm(xt, dim=1)
    in_cone = nx <= t
    in_polar = nx <= -t
    scale = (nx + t) / 2.0
    safe_nx = torch.where(nx > 0, nx, torch.ones_like(nx))
    zero = torch.zeros_like(t)
    t_new = torch.where(in_cone, t, torch.where(in_polar, zero, scale))
    xt_new = torch.where(
        in_cone[:, None],
        xt,
        torch.where(in_polar[:, None], torch.zeros_like(xt),
                    (scale / safe_nx)[:, None] * xt),
    )
    return torch.cat([t_new[:, None], xt_new], dim=1)


def _psd_gather(v_ext, bucket: PsdBucket):
    """[B, k, k] stack of the bucket's blocks from the extended vector."""
    if bucket.fastpath == "matmul":
        # uniform contiguous triangle bucket: a contiguous slice and one
        # selection matmul (svec -> full, 1/sqrt2 folded in)
        B, start = bucket.batch, bucket.contig_start
        V = v_ext[start:start + B * bucket.tri_len].reshape(B, bucket.tri_len)
        return (V @ bucket.expand).reshape(B, bucket.side, bucket.side)
    if bucket.fastpath == "colpad":
        # column-padded storage: the block's rows are an [r0, r0] matrix
        # with columns as rows; mask and scale it (diagonal halved), then
        # U + U^T is the symmetric block: no gather
        B, r0, start = bucket.batch, bucket.r0, bucket.contig_start
        U = v_ext[start:start + B * bucket.tri_len].reshape(B, r0, r0) * bucket.sym_scale
        return U + U.transpose(-1, -2)
    if bucket.fastpath == "shear":
        # large side: svec column j is a contiguous run, so one gather of
        # the [r0, r0] index (column starts + 0..r0-1) from the block's
        # rows padded by r0 zeros shears the columns into rows; the entries
        # past a column's end are masked
        B, r0, k, start = bucket.batch, bucket.r0, bucket.side, bucket.contig_start
        V = v_ext[start:start + B * bucket.tri_len].reshape(B, bucket.tri_len)
        Vp = torch.nn.functional.pad(V, (0, r0))
        U = Vp[:, bucket.sh_idx] * bucket.sym_scale       # [B, j, i]
        X = U + U.transpose(-1, -2)
        if r0 < k:
            X = torch.nn.functional.pad(X, (0, k - r0, 0, k - r0))
        return X
    X = v_ext[bucket.gather_idx] * bucket.gather_scale
    if bucket.symmetrize:
        X = 0.5 * (X + X.transpose(-1, -2))
    return X


def _psd_project_bucket(X, cones: ConeData, bucket: PsdBucket | None = None):
    """Batched PSD projection [B, k, k] -> [B, k, k] with the bucket's
    backend (the per-bucket override wins over the ConeData-wide one)."""
    backend = resolve_eigh_backend(cones.eigh_backend, device=X.device)
    if bucket is not None and bucket.backend:
        backend = bucket.backend
    if backend == "pallas":
        return jacobi_proj.psd_project_pallas(X, cones.jacobi_sweeps)
    if backend == "polar":
        return eigh_mod.psd_project_polar(X)
    if backend == "jacobi":
        return eigh_mod.psd_project_jacobi(X, cones.jacobi_sweeps)
    if backend == "xla":
        return eigh_mod.psd_project_eigh(X)
    raise ValueError(f"unknown eigh_backend {backend!r}")


def project(w2, cones: ConeData):
    """s = Pi_K(w2): project the slack part of the operator variable onto K
    (replaces admm_z!'s fan-out, reference: src/solver.jl:7-21)."""
    s = torch.clamp(w2, cones.lb, cones.ub)
    v_ext = _ext(w2)

    for bucket in cones.soc_buckets:
        P = _soc_project_bucket(v_ext[bucket.idx])
        s_ext = _ext(s)
        s_ext[bucket.idx] = P
        s = s_ext[:-1]

    for bucket in cones.psd_buckets:
        Y = _psd_project_bucket(_psd_gather(v_ext, bucket), cones, bucket)
        s = _psd_scatter(s, Y, bucket)
    return s


def _psd_scatter(s, Y, bucket: PsdBucket):
    """``s`` with the bucket's rows set from the [B, k, k] stack ``Y`` (in
    place on a fast path: ``s`` must be the caller's own tensor)."""
    B, start = bucket.batch, bucket.contig_start
    if bucket.fastpath == "matmul":
        T = Y.reshape(B, bucket.side * bucket.side) @ bucket.compress
    elif bucket.fastpath == "colpad":
        # [j, i] layout: the upper entries scaled, the pad slots 0
        T = Y.transpose(-1, -2) * bucket.cp_csc
    elif bucket.fastpath == "shear":
        r0 = bucket.r0
        T = Y[:, :r0, :r0].reshape(B, r0 * r0)[:, bucket.sh_flat] * bucket.sh_csc
    else:
        s_ext = _ext(s)
        s_ext[bucket.scatter_idx] = Y * bucket.scatter_scale
        return s_ext[:-1]
    s[start:start + B * bucket.tri_len] = T.reshape(-1)
    return s


# ----------------------------------------------------------------------
# Membership tests (used by the infeasibility certificates)
# ----------------------------------------------------------------------

def _psd_all_pd(X, tol):
    """All blocks of X [B, k, k] have min eigenvalue > -tol: one batched
    Cholesky of X + tol I (the reference's own membership test, LAPACK
    cholesky!, algebra.jl:226-233). ``cholesky_ex`` reports a failed
    factorization in ``info`` instead of raising; zero-padded slots get a
    tol diagonal and stay PD."""
    k = X.shape[-1]
    Xs = X + tol * torch.eye(k, dtype=X.dtype, device=X.device)
    L, info = torch.linalg.cholesky_ex(Xs)
    return (info == 0).all() & torch.isfinite(L).all()


def _max0(v):
    """max(v) with an initial value of 0 (0 for an empty v)."""
    if v.numel() == 0:
        return v.new_zeros(())
    return torch.clamp(v.max(), min=0.0)


def in_pol_recc_multi(v, cones: ConeData, tols):
    """Is v in the polar recession cone of K, at every tolerance in
    ``tols`` from one pass over the PSD gathers (the dual infeasibility
    certificate; reference: infeasibility.jl:32-68). Returns a tuple of
    0-d bool tensors."""
    v_ext = _ext(v)
    zero = torch.zeros_like(v)
    margin = _max0(torch.where(cones.eq_mask, v.abs(), zero))
    margin = torch.maximum(margin, _max0(torch.where(cones.nonneg_mask, v, zero)))
    # Box rows: v > tol only allowed if u finite; v < -tol only if l finite
    margin = torch.maximum(margin, _max0(torch.where(
        cones.box_mask & torch.isposinf(cones.ub), v, zero)))
    margin = torch.maximum(margin, _max0(torch.where(
        cones.box_mask & torch.isneginf(cones.lb), -v, zero)))
    for bucket in cones.soc_buckets:
        X = v_ext[bucket.idx]
        nx = torch.linalg.vector_norm(X[:, 1:], dim=1)
        margin = torch.maximum(margin, (nx + X[:, 0]).max())
    psd_X = [_psd_gather(v_ext, bucket) for bucket in cones.psd_buckets]

    oks = []
    for tol in tols:
        ok = margin <= tol
        for X in psd_X:
            # lambda_max(X) <= tol  <=>  tol I - X is PSD
            ok = ok & _psd_all_pd(-X, tol)
        oks.append(ok)
    return tuple(oks)


def support_function_multi(y, cones: ConeData, tols):
    """sup_{z in K} <z, y> as the reference evaluates it for the primal
    infeasibility certificate (convexset.jl:850-936): a finite sum over Box
    rows and a 0 / +inf indicator for the cones, at every tolerance in
    ``tols``. Returns a tuple of 0-d tensors."""
    v_ext = _ext(y)
    zero = torch.zeros_like(y)
    inf = torch.full((), float("inf"), dtype=y.dtype, device=y.device)
    margin = _max0(torch.where(cones.nonneg_mask, y, zero))
    for bucket in cones.soc_buckets:
        X = -v_ext[bucket.idx]
        nx = torch.linalg.vector_norm(X[:, 1:], dim=1)
        margin = torch.maximum(margin, (nx - X[:, 0]).max())
    psd_Xn = [_psd_gather(-v_ext, bucket) for bucket in cones.psd_buckets]

    outs = []
    for tol in tols:
        # Box rows (convexset.jl:850-856); guard 0 * inf
        contrib = torch.where(y > tol, y * cones.ub,
                              torch.where(y < -tol, y * cones.lb, zero))
        box_sum = torch.where(cones.box_mask, contrib, zero).sum()
        ok = margin <= tol
        for X in psd_Xn:
            # lambda_min(X) >= -tol  <=>  X + tol I is PSD
            ok = ok & _psd_all_pd(X, tol)
        outs.append(torch.where(ok, box_sum, inf))
    return tuple(outs)
