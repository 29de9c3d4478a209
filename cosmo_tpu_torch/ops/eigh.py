"""Batched symmetric eigendecomposition and PSD projection of many small
blocks in plain PyTorch (the port of ``cosmo_tpu.ops.eigh``).

* :func:`jacobi_eigh` — cyclic Jacobi with the round-robin pair schedule;
  each round applies its k/2 disjoint rotations at once as row and column
  updates of the whole [B, k, k] stack (the "vec" method);
* :func:`psd_project_polar` — the Newton-Schulz polar projection, pure
  batched matmuls, the auto choice for every bucket the Jacobi kernel does
  not take on a CUDA device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _round_robin_rounds(k: int):
    """Static round-robin pairings: k-1 rounds of k/2 disjoint pairs
    (circle method). Requires k even."""
    if k % 2 != 0:
        raise ValueError(f"the round-robin schedule needs an even side, got {k}")
    players = list(range(k))
    rounds = []
    for _ in range(k - 1):
        pairs = [(players[i], players[k - 1 - i]) for i in range(k // 2)]
        rounds.append(
            (
                np.array([min(a, b) for a, b in pairs], dtype=np.int32),
                np.array([max(a, b) for a, b in pairs], dtype=np.int32),
            )
        )
        players = [players[0], players[-1]] + players[1:-1]
    return tuple(rounds)


def rotation_angles(app, aqq, apq):
    """(c, s) of the Jacobi rotation that zeroes a_pq, with the guards of
    the TPU kernel: the identity rotation when |a_pq| <= 16 * tiny, and
    t = 1 (a 45-degree rotation) when tau == 0."""
    tiny = torch.finfo(apq.dtype).tiny * 16
    small = apq.abs() <= tiny
    safe_apq = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, torch.ones_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, torch.ones_like(c), c)
    s = torch.where(small, torch.zeros_like(s), s)
    return c, s


def _apply_round_vec(X, V, p, q):
    """One round: zero X[p, q] for k/2 disjoint pairs at once, as row
    updates of X, then column updates of X and of V (in place)."""
    c, s = rotation_angles(X[:, p, p], X[:, q, q], X[:, p, q])
    cc = c[:, :, None]
    ss = s[:, :, None]
    # rows: X <- J' X
    Xp = X[:, p, :]
    Xq = X[:, q, :]
    X[:, p, :] = cc * Xp - ss * Xq
    X[:, q, :] = ss * Xp + cc * Xq
    # cols: X <- X J
    cr = cc.transpose(1, 2)
    sr = ss.transpose(1, 2)
    Xp = X[:, :, p]
    Xq = X[:, :, q]
    X[:, :, p] = cr * Xp - sr * Xq
    X[:, :, q] = sr * Xp + cr * Xq
    # eigenvectors: V <- V J
    Vp = V[:, :, p]
    Vq = V[:, :, q]
    V[:, :, p] = cr * Vp - sr * Vq
    V[:, :, q] = sr * Vp + cr * Vq


def jacobi_eigh(X, sweeps: int = 8, rounds=None):
    """Eigendecomposition of a stack of symmetric matrices [B, k, k] by
    cyclic Jacobi. Returns (w, V) with w unsorted, X = V diag(w) V' up to
    rounding. ``rounds``: the schedule of a sweep, k-1 pairs of (p, q)
    index arrays whose rotation at (p, q) zeroes X[p, q]; default the
    round-robin one. Odd k goes to ``torch.linalg.eigh``."""
    B, k, _ = X.shape
    if k % 2 != 0:
        return torch.linalg.eigh(X)
    X = X.clone()
    V = torch.eye(k, dtype=X.dtype, device=X.device).expand(B, k, k).clone()
    rounds = [
        (torch.as_tensor(p, dtype=torch.long, device=X.device),
         torch.as_tensor(q, dtype=torch.long, device=X.device))
        for p, q in (rounds if rounds is not None else _round_robin_rounds(k))
    ]
    for _ in range(sweeps):
        for p, q in rounds:
            _apply_round_vec(X, V, p, q)
        X = 0.5 * (X + X.transpose(-1, -2))
    w = torch.diagonal(X, dim1=-2, dim2=-1)
    return w, V


def psd_reconstruct(w, V):
    """V max(w, 0) V' for a stack of eigenpairs."""
    return torch.einsum("bik,bk,bjk->bij", V, torch.clamp(w, min=0.0), V)


def psd_project_jacobi(X, sweeps: int = 8, rounds=None):
    """PSD projection via Jacobi: V max(w, 0) V'."""
    return psd_reconstruct(*jacobi_eigh(X, sweeps, rounds))


def psd_project_eigh(X):
    """PSD projection via ``torch.linalg.eigh`` (the "xla" backend)."""
    return psd_reconstruct(*torch.linalg.eigh(X))


def psd_project_polar(X, quintic_iters: int = 9, cubic_iters: int = 6):
    """PSD projection via the matrix sign function: Pi(X) = (X + |X|)/2 with
    |X| = X sign(X), the sign computed by Newton-Schulz on X/||X||_F: an
    aggressive quintic phase (3 matmuls a step), then the cubic polish
    (schedule of ``cosmo_tpu.ops.eigh.psd_project_polar``)."""
    a, bq, cq = 3.4445, -4.7750, 2.0315
    nrm = torch.sqrt(torch.sum(X * X, dim=(-2, -1), keepdim=True))
    Z = X / torch.clamp(nrm, min=torch.finfo(X.dtype).tiny)
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)

    def sym(M):
        return 0.5 * (M + M.transpose(-1, -2))

    for _ in range(quintic_iters):
        Y = Z @ Z
        Z = sym(Z @ (a * eye + bq * Y + cq * (Y @ Y)))
    for _ in range(cubic_iters):
        Z = sym(1.5 * Z - 0.5 * ((Z @ Z) @ Z))
    return sym(0.5 * (X + X @ Z))
