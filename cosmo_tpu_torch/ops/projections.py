"""Batched cone projections and membership tests (the port of
``cosmo_tpu.ops.projections``; reference: src/convexset.jl:885-891).

The composite projection is a fixed sequence of batched ops:

1. one elementwise clip covering Zero/Nonnegatives/Box rows,
2. one vectorized SOC projection per SOC bucket,
3. one batched PSD projection per PSD bucket (gather -> project -> scatter);
   with the ``"amortized"`` backend each bucket's eigenbasis is carried
   from one projection to the next (:func:`init_eig_state`);
4. one kernel launch for all exponential cones and one for all power cones
   (:mod:`.exp_pow_proj`; the plain version on the CPU);
5. each custom cone's own projection on its slice.

Under a device mesh (``ConeData.shard``) each rank projects its slices of
the stacks and writes them, with the clip of its own rows, into one zero
vector; one sum reassembles the projection on every rank. A PSD bucket of
fewer blocks than ranks is projected whole on every rank, its polar's
products split over the matrix rows, and rank 0 writes it, as it writes
the custom cones. The membership tests combine their ranks' verdicts.
"""
from __future__ import annotations

import torch

from . import eigh as eigh_mod
from . import exp_pow
from . import exp_pow_proj
from . import jacobi_eig
from . import jacobi_proj
from .conedata import ConeData, PsdBucket, resolve_eigh_backend
from .shard import split_rows_mm


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


def _psd_project_bucket(X, cones: ConeData, bucket: PsdBucket | None = None,
                        loose: bool = False):
    """Batched PSD projection [B, k, k] -> [B, k, k] with the bucket's
    backend (the per-bucket override wins over the ConeData-wide one).
    ``loose``: the mixed-precision phase (``cosmo_tpu.ops.projections:
    103-133``): the polar's float32 products run as three TF32 passes
    (``eigh.matmul_3xtf32``), the counterpart of the JAX package's
    ``precision="high"``; every other backend ignores it."""
    backend = resolve_eigh_backend(cones.eigh_backend, device=X.device)
    if bucket is not None and bucket.backend:
        backend = bucket.backend
    if backend == "pallas":
        return jacobi_proj.psd_project_pallas(X, cones.jacobi_sweeps)
    if backend == "polar":
        if bucket is not None and bucket.split is not None:
            return eigh_mod.psd_project_polar(
                X, tf32=loose, split=lambda mm: split_rows_mm(bucket.split, mm))
        return eigh_mod.psd_project_polar(X, tf32=loose)
    if backend in ("jacobi", "jacobi_mm"):
        method = "mm" if backend == "jacobi_mm" else "vec"
        return eigh_mod.psd_project_jacobi(X, cones.jacobi_sweeps, method)
    if backend == "xla":
        return eigh_mod.psd_project_eigh(X)
    raise ValueError(f"unknown eigh_backend {backend!r}")


def init_eig_state(cones: ConeData, dtype, device):
    """The first eigenbasis carry of the ``"amortized"`` backend: an
    identity stack a PSD bucket (the staleness guard then runs the full
    sweeps on the first projection); ``()`` for every other backend
    (``cosmo_tpu.ops.projections.init_eig_state``)."""
    if resolve_eigh_backend(cones.eigh_backend, device=device) != "amortized":
        return ()
    return tuple(
        torch.eye(b.side, dtype=dtype, device=device).expand(b.batch, b.side, b.side)
        .contiguous()
        for b in cones.psd_buckets
    )


def project(w2, cones: ConeData, eig_state=(), loose: bool = False):
    """s = Pi_K(w2): project the slack part of the operator variable onto K
    (replaces admm_z!'s fan-out, reference: src/solver.jl:7-21). Returns
    ``(s, eig_state)``: the state, one eigenbasis a PSD bucket, is carried
    only by the ``"amortized"`` backend, which projects every PSD bucket
    from it (:func:`init_eig_state`; the buckets' own backends do not
    apply), and is ``()`` otherwise. ``loose``: the mixed-precision phase
    flag (:func:`_psd_project_bucket`)."""
    amortized = resolve_eigh_backend(cones.eigh_backend, device=w2.device) == "amortized"
    s = torch.clamp(w2, cones.lb, cones.ub)
    sharded = cones.shard is not None
    if sharded:
        # the zero vector the ranks' parts are summed in, with a dump slot
        s = _ext(torch.where(cones.own_rows, s, torch.zeros_like(s)))
    v_ext = _ext(w2)

    for bucket in cones.soc_buckets:
        P = _soc_project_bucket(v_ext[bucket.idx])
        s_ext = _ext(s)
        s_ext[bucket.idx] = P
        s = s_ext[:-1]

    new_state = []
    for i, bucket in enumerate(cones.psd_buckets):
        X = _psd_gather(v_ext, bucket)
        if amortized:
            Y, V = jacobi_eig.psd_project_amortized(
                X, eig_state[i], warm_sweeps=2, full_sweeps=cones.jacobi_sweeps)
            new_state.append(V)
        else:
            Y = _psd_project_bucket(X, cones, bucket, loose)
        if bucket.split is None or bucket.split.lead:
            s = _psd_scatter(s, Y, bucket)

    ec, pc = cones.exp, cones.pow
    if ec is not None and ec.idx.shape[0] > 0:
        _set_rows(s, ec.idx, exp_pow_proj.project_exp(
            v_ext[ec.idx], ec.is_dual, ec.tol, ec.max_iter))
    if pc is not None and pc.idx.shape[0] > 0:
        _set_rows(s, pc.idx, exp_pow_proj.project_pow(
            v_ext[pc.idx], pc.alpha, pc.is_dual, pc.tol, pc.max_iter))

    for offset, cone in cones.custom:
        if not sharded or cones.shard.lead:
            s[offset:offset + cone.dim] = cone.project(w2[offset:offset + cone.dim])
    if sharded:
        s = cones.shard.sum(s)[:-1]
    return s, tuple(new_state)


def _set_rows(s, idx, P):
    """s[idx] = P in place; ``idx`` holds no dump slot, or ``s`` has one."""
    s[idx.reshape(-1)] = P.reshape(-1)


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

    stacked = []
    for tol in tols:
        # in_pol_recc(v) = in_dual(-v); a dual cone's dual is the cone
        ok = _exp_pow_in_dual(-v_ext, cones, tol)
        for X in psd_X:
            # lambda_max(X) <= tol  <=>  tol I - X is PSD
            ok = ok & _psd_all_pd(-X, tol)
        stacked.append(ok)
    margin, stacked = _combine(cones, margin, stacked)
    oks = []
    for tol, ok in zip(tols, stacked):
        ok = ok & (margin <= tol)
        for offset, cone in cones.custom:
            v_c = v[offset:offset + cone.dim]
            if cone.in_pol_recc is not None:
                ok = ok & _as_flag(cone.in_pol_recc(v_c, tol), v)
            elif cone.in_dual is not None:
                # the polar recession cone of a cone K is -K*
                ok = ok & _as_flag(cone.in_dual(-v_c, tol), v)
            else:
                # unknown membership: never certify through this cone
                ok = ok & _as_flag(False, v)
        oks.append(ok)
    return tuple(oks)


def _combine(cones: ConeData, margin, oks):
    """The membership margin and the per-tolerance verdicts of this rank's
    stack slices combined over the mesh (one max); as they are without a
    mesh."""
    if cones.shard is None:
        return margin, oks
    both = cones.shard.max(torch.stack([margin] + [(~ok).to(margin.dtype) for ok in oks]))
    return both[0], [bad == 0 for bad in both[1:]]


def _as_flag(flag, like):
    """A custom cone's answer as a 0-d bool tensor on ``like``'s device."""
    return torch.as_tensor(flag, device=like.device).to(torch.bool).reshape(())


def _exp_pow_in_dual(v_ext, cones: ConeData, tol):
    """All exp and pow rows of ``v_ext`` in the dual of their cone (the
    cone itself for a dual cone), at ``tol`` (cosmo_tpu.ops.projections:
    303-314, :369-379)."""
    ok = torch.ones((), dtype=torch.bool, device=v_ext.device)
    ec, pc = cones.exp, cones.pow
    if ec is not None and ec.idx.shape[0] > 0:
        V = v_ext[ec.idx]
        ok = ok & torch.where(ec.is_dual, exp_pow.exp_in_cone(V, tol),
                              exp_pow.exp_in_dual(V, tol)).all()
    if pc is not None and pc.idx.shape[0] > 0:
        V = v_ext[pc.idx]
        ok = ok & torch.where(pc.is_dual, exp_pow.pow_in_cone(V, pc.alpha, tol),
                              exp_pow.pow_in_dual(V, pc.alpha, tol)).all()
    return ok


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

    stacked = []
    for tol in tols:
        ok = _exp_pow_in_dual(-v_ext, cones, tol)
        for X in psd_Xn:
            # lambda_min(X) >= -tol  <=>  X + tol I is PSD
            ok = ok & _psd_all_pd(X, tol)
        stacked.append(ok)
    margin, stacked = _combine(cones, margin, stacked)
    outs = []
    for tol, ok in zip(tols, stacked):
        # Box rows (convexset.jl:850-856); guard 0 * inf
        contrib = torch.where(y > tol, y * cones.ub,
                              torch.where(y < -tol, y * cones.lb, zero))
        box_sum = torch.where(cones.box_mask, contrib, zero).sum()
        ok = ok & (margin <= tol)
        custom_sum = torch.zeros((), dtype=y.dtype, device=y.device)
        for offset, cone in cones.custom:
            y_c = y[offset:offset + cone.dim]
            if cone.support is not None:
                custom_sum = custom_sum + cone.support(y_c, tol)
            elif cone.in_dual is not None:
                # a cone's support is 0 iff -y lies in its dual, else +inf
                ok = ok & _as_flag(cone.in_dual(-y_c, tol), y)
            else:
                ok = ok & _as_flag(False, y)
        outs.append(torch.where(ok, box_sum + custom_sum, inf))
    return tuple(outs)
