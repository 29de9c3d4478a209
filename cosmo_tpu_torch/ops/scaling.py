"""Ruiz equilibration on the device (the port of ``cosmo_tpu.ops.scaling``;
reference: src/scaling.jl:21-116). Non-separable cones are rectified to one
scalar scaling per cone (scaling.jl:129-142) with a segment mean over the
precomputed cone-row segments."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import linops
from .conedata import ConeData


class ScaleMats(NamedTuple):
    """Diagonal scaling state (reference ScaleMatrices, src/types.jl)."""

    D: torch.Tensor      # [n]
    E: torch.Tensor      # [m]
    c: torch.Tensor      # 0-d cost scaling
    Dinv: torch.Tensor
    Einv: torch.Tensor
    cinv: torch.Tensor


def identity_scale(m: int, n: int, dtype, device) -> ScaleMats:
    one = torch.ones((), dtype=dtype, device=device)
    return ScaleMats(
        D=torch.ones(n, dtype=dtype, device=device),
        E=torch.ones(m, dtype=dtype, device=device), c=one,
        Dinv=torch.ones(n, dtype=dtype, device=device),
        Einv=torch.ones(m, dtype=dtype, device=device), cinv=one,
    )


def _limit_scaling(s, dyn):
    """clip(s, MIN_SCALING, MAX_SCALING) with values below MIN mapped to 1,
    so zero norms don't blow up (reference: scaling.jl:10-18)."""
    return torch.where(s < dyn.min_scaling, torch.ones_like(s),
                       torch.minimum(s, dyn.max_scaling))


def ruiz_scale(P, A, q, b, cones: ConeData, iters: int, dyn):
    """Equilibrate (P, q, A, b); returns the scaled data, the scaled cone
    bounds and the ScaleMats."""
    n = q.shape[0]
    m = b.shape[0]
    D = torch.ones_like(q)
    E = torch.ones_like(b)
    c = torch.ones((), dtype=q.dtype, device=q.device)
    for _ in range(iters):
        # KKT column norms (reference: scaling.jl:3-8)
        d_norm = torch.maximum(linops.colmax_abs(P), linops.colmax_abs(A))
        e_norm = linops.rowmax_abs(A)
        dw = 1.0 / torch.sqrt(_limit_scaling(d_norm, dyn))
        ew = 1.0 / torch.sqrt(_limit_scaling(e_norm, dyn))

        P = linops.scale_rows_cols(P, dw, dw)
        A = linops.scale_rows_cols(A, ew, dw)
        q = dw * q
        b = ew * b
        D = D * dw
        E = E * ew

        # cost scaling (reference: scaling.jl:66-83)
        mean_col_norm_P = linops.colmax_abs(P).mean()
        inf_norm_q = q.abs().max() if n > 0 else q.new_zeros(())
        do_cost = (mean_col_norm_P != 0.0) & (inf_norm_q != 0.0)
        scale_cost = _limit_scaling(
            torch.maximum(_limit_scaling(inf_norm_q, dyn), mean_col_norm_P), dyn
        )
        ctmp = torch.where(do_cost, 1.0 / scale_cost, torch.ones_like(scale_cost))
        P = linops.scale_all(P, ctmp)
        q = q * ctmp
        c = c * ctmp

    # rectify cones that only admit scalar scaling (scaling.jl:87-97)
    if cones.n_rect_segments > 0:
        nseg = cones.n_rect_segments + 1  # + dump segment
        seg_sum = E.new_zeros(nseg).index_add_(
            0, cones.rect_seg, torch.where(cones.rect_mask, E, torch.zeros_like(E)))
        seg_cnt = E.new_zeros(nseg).index_add_(
            0, cones.rect_seg, cones.rect_mask.to(E.dtype))
        seg_mean = seg_sum / torch.clamp(seg_cnt, min=1.0)
        ework = torch.where(cones.rect_mask, seg_mean[cones.rect_seg] / E,
                            torch.ones_like(E))
        A = linops.scale_rows(A, ework)
        b = ework * b
        E = E * ework

    P = linops.symmetrize(P)  # reference: scaling.jl:99

    # scaled set bounds (Box rows; 0 and +/-inf rows are invariant)
    lb = cones.lb * E
    ub = cones.ub * E

    sm = ScaleMats(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
    return P, A, q, b, lb, ub, sm


def scale_variables(x, mu, s, sm: ScaleMats):
    """Move warm-started variables into scaled space (scaling.jl:118-123)."""
    return sm.Dinv * x, sm.c * (sm.Einv * mu), sm.E * s


def unscale_variables(x, mu, s, sm: ScaleMats):
    """reverse_scaling! (reference: scaling.jl:170-179)."""
    return sm.D * x, sm.cinv * (sm.E * mu), sm.Einv * s
