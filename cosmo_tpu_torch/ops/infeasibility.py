"""Infeasibility certificates (Banjac et al.; the port of
``cosmo_tpu.ops.infeasibility``, reference: src/infeasibility.jl).

The JAX package runs the PSD membership battery under a ``lax.cond`` on the
certificate's cheap scalar preconditions. Every certificate CONJOINS those
preconditions, so evaluating the battery unconditionally and ANDing gives
the same answer; it is done that way here, which keeps the check free of a
host synchronization (the battery is one batched Cholesky per PSD bucket).
"""
from __future__ import annotations

import torch

from . import projections
from .conedata import ConeData
from .linops import matvec, rmatvec


def _min_tol(tols):
    out = tols[0]
    for t in tols[1:]:
        out = torch.minimum(out, t)
    return out


def is_primal_infeasible_multi(dy, A, b, cones: ConeData, sm, tols):
    """delta_y certificate (reference: infeasibility.jl:1-29) at every
    tolerance in ``tols``. Returns a tuple of 0-d bool tensors."""
    norm_dy = (sm.E * dy).abs().max()
    safe_norm = torch.where(norm_dy > _min_tol(tols), norm_dy,
                            torch.ones_like(norm_dy))
    A_dy_max = (sm.Dinv * rmatvec(A, dy)).abs().max()
    dy_unit = dy * (-1.0 / safe_norm)
    dyt_b = torch.dot(dy_unit, b)
    sFs = projections.support_function_multi(dy_unit, cones, tols)
    return tuple(
        (norm_dy > tol) & (A_dy_max <= tol * norm_dy) & (sF - dyt_b <= tol)
        for tol, sF in zip(tols, sFs)
    )


def is_primal_infeasible(dy, A, b, cones: ConeData, sm, eps_prim_inf):
    return is_primal_infeasible_multi(dy, A, b, cones, sm, (eps_prim_inf,))[0]


def is_dual_infeasible_multi(dx, P, A, q, cones: ConeData, sm, tols):
    """delta_x certificate (reference: infeasibility.jl:32-68) at every
    tolerance in ``tols``. Returns a tuple of 0-d bool tensors."""
    norm_dx = (sm.D * dx).abs().max()
    safe_norm = torch.where(norm_dx > _min_tol(tols), norm_dx,
                            torch.ones_like(norm_dx))
    qt_dx = torch.dot(q, dx) / (safe_norm * sm.c)
    P_dx_max = (sm.Dinv * matvec(P, dx)).abs().max() / (safe_norm * sm.c)
    A_dx = (sm.Einv * matvec(A, dx)) / safe_norm
    cond_Ks = projections.in_pol_recc_multi(A_dx, cones, tols)
    return tuple(
        (norm_dx > tol) & (qt_dx < -tol) & (P_dx_max <= tol) & cond_K
        for tol, cond_K in zip(tols, cond_Ks)
    )


def is_dual_infeasible(dx, P, A, q, cones: ConeData, sm, eps_dual_inf):
    return is_dual_infeasible_multi(dx, P, A, q, cones, sm, (eps_dual_inf,))[0]
