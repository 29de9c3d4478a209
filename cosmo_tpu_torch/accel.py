"""Safeguarded Anderson acceleration (the port of ``cosmo_tpu.accel``;
reference: COSMOAccelerators.jl driven through src/accelerator_interface.jl).

The history lives in two ``[mem, d]`` device tensors written in place at a
device-side slot (``index_copy_``), and every other field of the state is a
0-d device tensor: :func:`update`, :func:`accelerate` and :func:`restart`
never make the host wait for the device. The ``gate`` arguments make a call
an exact no-op by value selection, so the solver runs both every iteration
without a host-side branch on a device flag.

The default matches the reference's ``AndersonAccelerator{T,
Type2{QRDecomp}, RestartedMemory, NoRegularizer}`` (src/settings.jl:136)
through the normal equations of the ``mem x mem`` secant system, as the JAX
package does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class AccelState:
    """The accelerator's state (``cosmo_tpu.accel.AccelState``); the
    history ``dF``/``dG`` is shared by every copy made with
    ``dataclasses.replace`` and written in place by :func:`update`."""

    x_last: Any             # [d]
    g_last: Any             # [d]
    f_last: Any             # [d]  f = x - g at the last genuine ADMM step
    dF: Any                 # [mem, d] residual differences
    dG: Any                 # [mem, d] map-output differences
    count: Any              # int32: valid history pairs
    have_last: Any          # bool
    active: Any             # bool: activation reached
    success: Any            # bool: an accelerated candidate this iteration
    n_accelerated: Any      # int32
    n_declined: Any         # int32 safeguard rejections
    # the stagnation toggle (no reference analog; f32 robustness): the
    # solver's termination checks flip the suspension state when the
    # residual stops improving (cosmo_tpu.accel.AccelState)
    disabled: Any           # bool: accelerator currently suspended
    stall_checks: Any       # int32 consecutive no-progress checks
    n_trips: Any            # int32 divergence strikes (never reset)
    best_score: Any         # best normalized residual score seen
    # the safeguard's divergence anchor: the smallest ||f|| at a genuine
    # ADMM base point since the last restart
    best_nrm_f: Any
    rows: Any               # int64 [mem]: 0 .. mem-1 (constant)


def init_accel(d: int, mem: int, dtype, device) -> AccelState:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    def flag(v):
        return torch.tensor(v, dtype=torch.bool, device=device)

    def inf():
        return torch.tensor(float("inf"), dtype=dtype, device=device)

    z = torch.zeros(d, dtype=dtype, device=device)
    return AccelState(
        x_last=z, g_last=z, f_last=z,
        dF=torch.zeros((mem, d), dtype=dtype, device=device),
        dG=torch.zeros((mem, d), dtype=dtype, device=device),
        count=i32(0), have_last=flag(False), active=flag(False), success=flag(False),
        n_accelerated=i32(0), n_declined=i32(0), disabled=flag(False),
        stall_checks=i32(0), n_trips=i32(0), best_score=inf(), best_nrm_f=inf(),
        rows=torch.arange(mem, device=device),
    )


def restart(aa: AccelState) -> AccelState:
    """Empty the history (reference: CA.restart! on rho adaptation,
    solver.jl:274); the anchor norm lives in the rho-scaled space, so it
    goes too."""
    return dataclasses.replace(
        aa, count=torch.zeros_like(aa.count),
        have_last=torch.zeros_like(aa.have_last),
        success=torch.zeros_like(aa.success),
        best_nrm_f=torch.full_like(aa.best_nrm_f, float("inf")),
    )


def update(aa: AccelState, g, x, memory: str = "restarted", gate=None) -> AccelState:
    """Push the pair (x, g = T(x)) into the history (CA.update! semantics;
    f = x - g). ``memory``: "restarted" empties a full history and skips
    this push, so the next :func:`accelerate` has no history and the
    iteration runs plain ADMM (the reference's RestartedMemory cadence);
    "rolling" overwrites the oldest pair (RollingMemory). ``gate`` (a 0-d
    bool tensor or None): False makes the call an exact no-op."""
    mem = aa.dF.shape[0]
    f = x - g
    if memory == "rolling":
        slot = torch.remainder(aa.count, mem)
        # saturating counter that keeps the write phase
        count_next = torch.where(aa.count >= 2 * mem, mem + slot + 1, aa.count + 1)
        full = torch.zeros_like(aa.have_last)
    else:
        full = aa.count >= mem
        slot = torch.where(full, torch.zeros_like(aa.count), aa.count)
        count_next = slot + 1
    push = aa.have_last & ~full
    if gate is not None:
        push = push & gate
    # a non-finite secant never enters the history: a zero row fails the
    # Gram's rank test instead, declining the candidate
    df_new = f - aa.f_last
    dg_new = g - aa.g_last
    row_ok = torch.isfinite(df_new).all() & torch.isfinite(dg_new).all()
    idx = slot.to(torch.int64).reshape(1)
    zero = df_new.new_zeros(())
    # value-gated row write: the old row goes back when nothing is pushed
    df_row = torch.where(push & row_ok, df_new,
                         torch.where(push, zero, aa.dF.index_select(0, idx)[0]))
    dg_row = torch.where(push & row_ok, dg_new,
                         torch.where(push, zero, aa.dG.index_select(0, idx)[0]))
    aa.dF.index_copy_(0, idx, df_row[None])
    aa.dG.index_copy_(0, idx, dg_row[None])
    count = torch.where(push, count_next,
                        torch.where(aa.have_last & full, torch.zeros_like(aa.count),
                                    aa.count)).to(torch.int32)
    if gate is not None:
        count = torch.where(gate, count, aa.count)
        x = torch.where(gate, x, aa.x_last)
        g = torch.where(gate, g, aa.g_last)
        f = torch.where(gate, f, aa.f_last)
        have_last = aa.have_last | gate
    else:
        have_last = torch.ones_like(aa.have_last)
    return dataclasses.replace(aa, x_last=x, g_last=g, f_last=f, count=count,
                               have_last=have_last)


def _spectral_norm_psd(S, squarings: int = 7):
    """Largest eigenvalue of a stack of symmetric PSD matrices [B, n, n]
    from tr(S^(2^squarings))^(1/2^squarings) of S scaled to unit trace: at
    most n^(1/2^squarings) above it (1.021 for n = 15 at the default),
    never below, with no iteration-dependent control flow."""
    tr = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)
    Z = S / torch.clamp(tr, min=torch.finfo(S.dtype).tiny)[:, None, None]
    Zp = torch.linalg.matrix_power(Z, 2 ** squarings)
    return tr * torch.diagonal(Zp, dim1=-2, dim2=-1).sum(-1) ** (1.0 / 2 ** squarings)


def _well_conditioned(G_raw, active_row, n_active, c):
    """Sync-free form of the reference's rank test (``cosmo_tpu.accel``:
    the ``n_active``-th largest singular value of the masked ``G_raw``
    clears ``c`` times the largest).

    The inactive rows and columns of ``G_raw`` are zero, so that test is
    kappa_2(G_a) < 1/c for its active block G_a. The active block is
    embedded in a matrix with the RMS singular value of G_a (its Frobenius
    norm over sqrt(n_active), which lies between its least and largest
    singular value) on the inactive diagonal, so the embedding has G_a's
    condition number; kappa_2 = ||G|| ||G^-1|| with both norms the square
    root of :func:`_spectral_norm_psd` of M' M, in float64. An exactly
    singular block gives a non-finite inverse and fails. The estimate is at
    most 2.2% above kappa_2 (mem = 15), so the test declines at most that
    much early;
    ``torch.linalg.svd`` would give the exact value but makes the host wait
    for the device."""
    G = G_raw.to(torch.float64)
    mask2 = active_row[:, None] & active_row[None, :]
    G = torch.where(mask2, G, G.new_zeros(()))
    rms = torch.sqrt((G * G).sum() / torch.clamp(n_active, min=1).to(torch.float64))
    G = G + torch.diag_embed(torch.where(active_row, G.new_zeros(()), rms))
    Ginv, info = torch.linalg.inv_ex(G)
    M = torch.stack([G, Ginv])
    norms = torch.sqrt(_spectral_norm_psd(M.transpose(-1, -2) @ M))
    kappa = norms[0] * norms[1]
    return (info == 0) & torch.isfinite(kappa) & (kappa * c < 1.0)


def accelerate(aa: AccelState, w, aa_type: str = "type2",
               regularizer: str = "none", gate=None):
    """The accelerated candidate w_acc = g - dG' gamma
    (``cosmo_tpu.accel.accelerate``):

    * ``"type2"``: gamma = argmin ||f - dF' gamma|| by the normal equations
      on dF dF' (reference Type2{NormalEquations});
    * ``"type2_qr"``: the same least squares through a QR of dF' (reference
      Type2{QRDecomp}); it ignores the regularizer;
    * ``"type1"``: gamma solves (dX dF') gamma = dX f with dX = dG + dF.

    ``regularizer`` (normal equations): "none" adds only a tiny jitter,
    "tikhonov" lambda I with lambda = 1e-8 ||G||_F, "frobenius" lambda =
    1e-10 ||dF||_F^2. A numerically rank-deficient secant system fails the
    iteration, as the reference's QR solve does. Returns (w_new, aa)."""
    mem = aa.dF.shape[0]
    eps = torch.finfo(w.dtype).eps
    n_active = torch.clamp(aa.count, max=mem)
    active_row = aa.rows < n_active                  # [mem]
    zero = w.new_zeros(())
    if aa_type == "type2_qr":
        # inactive rows are zero columns of dF' -> zero R diagonal -> masked
        Fm = torch.where(active_row[:, None], aa.dF, zero)
        Q, R = torch.linalg.qr(Fm.T, mode="reduced")  # [d, mem], [mem, mem]
        rhs = Q.T @ aa.f_last
        diag = torch.diagonal(R).abs()
        good = diag > (eps * mem) * torch.clamp(diag.max(), min=1e-30)
        R_safe = R + torch.diag_embed(torch.where(good, zero, torch.ones_like(diag)))
        gamma = torch.linalg.solve_triangular(
            R_safe, torch.where(good, rhs, zero)[:, None], upper=True)[:, 0]
        gamma = torch.where(good, gamma, zero)
        # fail like the reference's QR solve: any degenerate active column
        well_cond = (good | ~active_row).all()
    else:
        # masks on the [mem, mem] Gram and the [mem] rhs instead of the
        # [mem, d] history: the same surviving dot products
        mask2 = active_row[:, None] & active_row[None, :]
        if aa_type == "type1":
            Xm = aa.dG + aa.dF
            G_raw = torch.where(mask2, Xm @ aa.dF.T, zero)
            rhs = torch.where(active_row, Xm @ aa.f_last, zero)
        else:
            G_raw = torch.where(mask2, aa.dF @ aa.dF.T, zero)
            rhs = torch.where(active_row, aa.dF @ aa.f_last, zero)
        if regularizer == "tikhonov":
            lam = 1e-8 * torch.linalg.matrix_norm(G_raw)
        elif regularizer == "frobenius":
            if aa_type == "type1":
                row_ss = torch.einsum("md,md->m", aa.dF, aa.dF)
                lam = 1e-10 * torch.where(active_row, row_ss, zero).sum()
            else:
                # the sum of squares over active rows = the masked Gram's trace
                lam = 1e-10 * torch.trace(G_raw)
        else:
            lam = 1e-13 * torch.clamp(torch.trace(G_raw).abs(), min=1.0)
        G = G_raw + torch.diag_embed(torch.where(active_row, lam, torch.ones_like(rhs)))
        gamma, _ = torch.linalg.solve_ex(G, rhs)
        well_cond = _well_conditioned(G_raw, active_row, n_active, eps * mem)
    # gamma is exactly 0 on inactive rows, so the combination reads the
    # unmasked history
    gamma = torch.where(active_row, gamma, zero)
    w_acc = aa.g_last - gamma @ aa.dG
    ok = torch.isfinite(w_acc).all() & (aa.count > 0) & well_cond
    if gate is not None:
        ok = ok & gate
    w_new = torch.where(ok, w_acc, w)
    return w_new, dataclasses.replace(
        aa, success=ok, n_accelerated=aa.n_accelerated + ok.to(torch.int32))
