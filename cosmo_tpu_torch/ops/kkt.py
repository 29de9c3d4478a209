"""The dense KKT solve of the ADMM x-update (the port of the dense branch of
``cosmo_tpu.ops.kkt``).

The reduced SPD system

    M x = r1 + A' (rho .* r2),     M = P + sigma I + A' diag(rho) A
    nu  = rho .* (A x - r2)

is solved through a cached Cholesky factor of M (refactored when rho
changes): two triangular solves per iteration, or — in float32 without
Anderson acceleration — one matvec with the explicit inverse M^-1 formed
from the factor. CG, MINRES and the compensated refinement are not ported
yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .linops import AtRhoA, matvec, rmatvec


class DenseKKTState(NamedTuple):
    L: torch.Tensor   # [n, n] lower Cholesky factor of M
    Minv: Any         # [n, n] explicit M^-1 = L^-T L^-1 (f32 only), or None


def dense_factor(P, A, sigma, rho_vec, use_inverse: bool = False) -> DenseKKTState:
    n = P.shape[0]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device) + AtRhoA(A, rho_vec)
    # a failed factorization gives a NaN factor, as JAX's cholesky does, so
    # the solve ends Unsolved instead of raising (and the host never waits)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    if M.dtype != torch.float32 or not use_inverse:
        # backward-stable triangular solves: the default, and always the
        # choice in f64 (the reference-parity mode)
        return DenseKKTState(L=L, Minv=None)
    # f32 + plain ADMM: apply-by-inverse, one [n, n] matvec per iteration
    # instead of two dependent triangular solves. Only without Anderson:
    # the inverse's ~1e-5 apply-error floor destabilizes safeguarded AA
    # (cosmo_tpu.ops.kkt.dense_factor)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Minv = Linv.T @ Linv
    return DenseKKTState(L=L, Minv=0.5 * (Minv + Minv.T))


def _chol_solve(L, t):
    y = torch.linalg.solve_triangular(L, t[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def _kkt_apply(state: DenseKKTState, t):
    if state.Minv is None:
        return _chol_solve(state.L, t)
    return state.Minv @ t


def dense_solve(state: DenseKKTState, A, rho_vec, r1, r2):
    """Solve the KKT system via the cached factor. Returns (x_tilde, nu)."""
    t = r1 + rmatvec(A, rho_vec * r2)
    x = _kkt_apply(state, t)
    nu = rho_vec * (matvec(A, x) - r2)
    return x, nu
