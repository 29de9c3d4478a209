"""Residuals, convergence and cost (the port of
``cosmo_tpu.ops.residuals``; reference: src/residuals.jl)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import df32
from .linops import matvec, rmatvec


class ResInfo(NamedTuple):
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    max_norm_prim: torch.Tensor
    max_norm_dual: torch.Tensor


def _inf(v):
    return v.abs().max() if v.shape[0] > 0 else v.new_zeros(())


def _mv(A, x, compensated: bool):
    if compensated:
        return df32.to_f32(df32.matvec2(A, df32.promote(x)))
    return matvec(A, x)


def _rmv(A, y, compensated: bool):
    if compensated:
        return df32.to_f32(df32.rmatvec2(A, df32.promote(y)))
    return rmatvec(A, y)


def calculate_residuals(P, A, q, b, x, s, mu, sm, ignore_scaling: bool = False,
                        compensated: bool = False):
    """||E^-1 (Ax + s - b)||_inf and ||c^-1 D^-1 (Px + q - A'mu)||_inf
    (reference: residuals.jl:30-53). ``compensated``: the matvecs in
    double-f32 (ops/df32.py), so that in float32 the measurement noise
    (~eps ||A|| ||x||) does not feed the rho adaptation near convergence."""
    r_prim = _mv(A, x, compensated) + s - b
    r_dual = _mv(P, x, compensated) + q - _rmv(A, mu, compensated)
    if not ignore_scaling:
        r_prim = sm.Einv * r_prim
        r_dual = sm.cinv * (sm.Dinv * r_dual)
    return _inf(r_prim), _inf(r_dual)


def max_res_component_norm(P, A, q, b, x, s, mu, sm, ignore_scaling: bool = False,
                           compensated: bool = False):
    """Denominators of the relative convergence criterion
    (reference: residuals.jl:56-96)."""
    if ignore_scaling:
        e = d = ci = 1.0
    else:
        e, d, ci = sm.Einv, sm.Dinv, sm.cinv
    mp = torch.maximum(_inf(e * _mv(A, x, compensated)),
                       torch.maximum(_inf(e * s), _inf(e * b)))
    md = torch.maximum(
        _inf(ci * (d * _mv(P, x, compensated))),
        torch.maximum(_inf(ci * (d * q)),
                      _inf(ci * (d * _rmv(A, mu, compensated)))),
    )
    return mp, md


def result_info(P, A, q, b, x, s, mu, sm, compensated: bool = False) -> ResInfo:
    rp, rd = calculate_residuals(P, A, q, b, x, s, mu, sm, compensated=compensated)
    mp, md = max_res_component_norm(P, A, q, b, x, s, mu, sm, compensated=compensated)
    return ResInfo(rp, rd, mp, md)


def has_converged(info: ResInfo, eps_abs, eps_rel):
    """residual < eps_abs + eps_rel * max_norm for both (residuals.jl:98-117)."""
    prim_ok = info.r_prim < eps_abs + eps_rel * info.max_norm_prim
    dual_ok = info.r_dual < eps_abs + eps_rel * info.max_norm_dual
    return prim_ok & dual_ok


def calculate_cost(P, q, x, cinv):
    """cost = cinv (0.5 x'Px + q'x) on scaled data (residuals.jl:143-147)."""
    return cinv * (0.5 * torch.dot(x, matvec(P, x)) + torch.dot(q, x))
