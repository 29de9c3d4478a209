"""Residuals, convergence and cost (the port of the plain, uncompensated
part of ``cosmo_tpu.ops.residuals``; reference: src/residuals.jl)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .linops import matvec, rmatvec


class ResInfo(NamedTuple):
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    max_norm_prim: torch.Tensor
    max_norm_dual: torch.Tensor


def _inf(v):
    return v.abs().max() if v.shape[0] > 0 else v.new_zeros(())


def calculate_residuals(P, A, q, b, x, s, mu, sm, ignore_scaling: bool = False):
    """||E^-1 (Ax + s - b)||_inf and ||c^-1 D^-1 (Px + q - A'mu)||_inf
    (reference: residuals.jl:30-53)."""
    r_prim = matvec(A, x) + s - b
    r_dual = matvec(P, x) + q - rmatvec(A, mu)
    if not ignore_scaling:
        r_prim = sm.Einv * r_prim
        r_dual = sm.cinv * (sm.Dinv * r_dual)
    return _inf(r_prim), _inf(r_dual)


def max_res_component_norm(P, A, q, b, x, s, mu, sm, ignore_scaling: bool = False):
    """Denominators of the relative convergence criterion
    (reference: residuals.jl:56-96)."""
    if ignore_scaling:
        e = d = ci = 1.0
    else:
        e, d, ci = sm.Einv, sm.Dinv, sm.cinv
    mp = torch.maximum(_inf(e * matvec(A, x)),
                       torch.maximum(_inf(e * s), _inf(e * b)))
    md = torch.maximum(
        _inf(ci * (d * matvec(P, x))),
        torch.maximum(_inf(ci * (d * q)), _inf(ci * (d * rmatvec(A, mu)))),
    )
    return mp, md


def result_info(P, A, q, b, x, s, mu, sm) -> ResInfo:
    rp, rd = calculate_residuals(P, A, q, b, x, s, mu, sm)
    mp, md = max_res_component_norm(P, A, q, b, x, s, mu, sm)
    return ResInfo(rp, rd, mp, md)


def has_converged(info: ResInfo, eps_abs, eps_rel):
    """residual < eps_abs + eps_rel * max_norm for both (residuals.jl:98-117)."""
    prim_ok = info.r_prim < eps_abs + eps_rel * info.max_norm_prim
    dual_ok = info.r_dual < eps_abs + eps_rel * info.max_norm_dual
    return prim_ok & dual_ok


def calculate_cost(P, q, x, cinv):
    """cost = cinv (0.5 x'Px + q'x) on scaled data (residuals.jl:143-147)."""
    return cinv * (0.5 * torch.dot(x, matvec(P, x)) + torch.dot(q, x))
