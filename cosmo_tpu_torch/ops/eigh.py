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

import contextlib
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


def _apply_round_mm(X, V, p, q):
    """The same round as :func:`_apply_round_vec` through one packed
    rotation J of the k/2 pairs: X <- J' X J and V <- V J as batched
    products (the "mm" method, ``cosmo_tpu.ops.eigh._apply_round``).
    Returns the new (X, V)."""
    B, k, _ = X.shape
    c, s = rotation_angles(X[:, p, p], X[:, q, q], X[:, p, q])
    J = torch.eye(k, dtype=X.dtype, device=X.device).repeat(B, 1, 1)
    J[:, p, p] = c
    J[:, q, q] = c
    J[:, p, q] = s
    J[:, q, p] = -s
    X = torch.bmm(torch.bmm(J.transpose(1, 2), X), J)
    return X, torch.bmm(V, J)


def _schedule(k, rounds, device):
    """The rounds of a sweep as (p, q) index tensors on ``device``: the
    given ones, or the round-robin schedule."""
    return [
        (torch.as_tensor(p, dtype=torch.long, device=device),
         torch.as_tensor(q, dtype=torch.long, device=device))
        for p, q in (rounds if rounds is not None else _round_robin_rounds(k))
    ]


def _jacobi_eigh_transposed(X, sweeps: int):
    """Jacobi in the transposed layout [k, k, B] (the "vecT" method,
    ``cosmo_tpu.ops.eigh._jacobi_eigh_transposed``): every rotation indexes
    the two leading axes. ``X`` is [B, k, k]; returns (w [B, k], V
    [B, k, k])."""
    B, k, _ = X.shape
    XT = X.permute(1, 2, 0).clone()
    VT = torch.eye(k, dtype=X.dtype, device=X.device)[:, :, None].repeat(1, 1, B)
    rounds = _schedule(k, None, X.device)
    for _ in range(sweeps):
        for p, q in rounds:
            c, s = rotation_angles(XT[p, p, :], XT[q, q, :], XT[p, q, :])  # [k/2, B]
            cr, sr = c[:, None, :], s[:, None, :]
            Xp, Xq = XT[p], XT[q]
            XT[p] = cr * Xp - sr * Xq
            XT[q] = sr * Xp + cr * Xq
            cc, sc = c[None, :, :], s[None, :, :]
            Xp, Xq = XT[:, p, :], XT[:, q, :]
            XT[:, p, :] = cc * Xp - sc * Xq
            XT[:, q, :] = sc * Xp + cc * Xq
            Vp, Vq = VT[:, p, :], VT[:, q, :]
            VT[:, p, :] = cc * Vp - sc * Vq
            VT[:, q, :] = sc * Vp + cc * Vq
        XT = 0.5 * (XT + XT.transpose(0, 1))
    ar = torch.arange(k, device=X.device)
    return XT[ar, ar, :].T, VT.permute(2, 0, 1)


def jacobi_eigh(X, sweeps=8, method: str = "vec", V0=None, rounds=None):
    """Eigendecomposition of a stack of symmetric matrices [B, k, k] by
    cyclic Jacobi (``cosmo_tpu.ops.eigh.jacobi_eigh``). Returns (w, V) with
    w unsorted, X = V diag(w) V' up to rounding.

    * ``sweeps``: an int or a 0-d tensor (read on the host);
    * ``method``: "vec" (a round's rotations as row and column updates),
      "mm" (as one packed rotation and batched products) or "vecT" (the
      "vec" rounds in the transposed layout; with ``V0`` it is "vec");
    * ``V0``: a starting basis; the rotations accumulate on it (V = V0 Q);
    * ``rounds``: the schedule of a sweep, k-1 pairs of (p, q) index arrays
      whose rotation at (p, q) zeroes X[p, q]; default the round-robin one.

    Odd k goes to ``torch.linalg.eigh`` (which ignores ``V0``, as the
    reference does)."""
    B, k, _ = X.shape
    if k % 2 != 0:
        return torch.linalg.eigh(X)
    sweeps = int(sweeps)
    if method == "vecT" and V0 is None and rounds is None:
        return _jacobi_eigh_transposed(X, sweeps)
    X = X.clone()
    V = (torch.eye(k, dtype=X.dtype, device=X.device).expand(B, k, k).clone()
         if V0 is None else V0.clone())
    schedule = _schedule(k, rounds, X.device)
    for _ in range(sweeps):
        for p, q in schedule:
            if method == "mm":
                X, V = _apply_round_mm(X, V, p, q)
            else:
                _apply_round_vec(X, V, p, q)
        X = 0.5 * (X + X.transpose(-1, -2))
    w = torch.diagonal(X, dim1=-2, dim2=-1)
    return w, V


def psd_reconstruct(w, V):
    """V max(w, 0) V' for a stack of eigenpairs."""
    return torch.einsum("bik,bk,bjk->bij", V, torch.clamp(w, min=0.0), V)


def psd_project_jacobi(X, sweeps: int = 8, method: str = "vec", rounds=None):
    """PSD projection via Jacobi: V max(w, 0) V'."""
    return psd_reconstruct(*jacobi_eigh(X, sweeps, method, rounds=rounds))


# the sides the Jacobi kernels take (cosmo_tpu/ops/pallas_eigh.py:257-266)
KERNEL_MIN_SIDE = 4
KERNEL_MAX_SIDE = 48


def kernel_takes(k: int) -> bool:
    """The reference wrapper's domain rule: even k in [4, 48]."""
    return k % 2 == 0 and KERNEL_MIN_SIDE <= k <= KERNEL_MAX_SIDE


# an eigenbasis is stale when a block's off-diagonal mass exceeds this share
# of its energy (cosmo_tpu.ops.eigh.psd_project_amortized)
STALE_SHARE = 0.09


def amortized_rotate(X, V_prev):
    """The torch part of the amortized projection: one Newton-Schulz step
    re-orthonormalises the carried basis (V (3I - V'V) / 2), W = V'XV is
    symmetrised, and ``stale`` (a 0-d bool tensor, left on the device) says
    whether any block's off-diagonal mass exceeds 9% of its energy (plus
    tiny). Returns (W, V, stale)."""
    B, k, _ = X.shape
    eye = torch.eye(k, dtype=X.dtype, device=X.device)
    V = 0.5 * torch.bmm(V_prev, 3.0 * eye.expand(B, k, k)
                        - torch.bmm(V_prev.transpose(-1, -2), V_prev))
    W = torch.bmm(V.transpose(-1, -2), torch.bmm(X, V))
    W = 0.5 * (W + W.transpose(-1, -2))
    diag = torch.diagonal(W, dim1=-2, dim2=-1)
    tot2 = torch.sum(W * W, dim=(-2, -1))
    off2 = tot2 - torch.sum(diag * diag, dim=-1)
    stale = torch.any(off2 > STALE_SHARE * tot2 + torch.finfo(X.dtype).tiny)
    return W, V, stale


def psd_project_amortized(X, V_prev, warm_sweeps: int = 2, full_sweeps: int = 8,
                          method: str = "vec"):
    """PSD projection with the eigenbasis carried across ADMM iterations
    (``cosmo_tpu.ops.eigh.psd_project_amortized``, operation for
    operation): :func:`amortized_rotate`, then ``warm_sweeps`` Jacobi
    sweeps on W from the re-orthonormalised basis, or ``full_sweeps`` when
    the basis is stale, then the symmetrised V max(w, 0) V'. The sweep
    count is read on the host: this is the plain version, for the CPU (the
    wrapper ``ops/jacobi_eig.psd_project_amortized`` runs the Jacobi part
    as a kernel on a CUDA device). Returns (P, V)."""
    W, V0, stale = amortized_rotate(X, V_prev)
    return jacobi_eig_plain(W, V0, stale, warm_sweeps, full_sweeps, method)


def jacobi_eig_plain(W, V0, stale, warm: int, full: int, method: str = "vec"):
    """The Jacobi part of the amortized projection, the function of the
    kernel ``jacobi_eig``: ``full`` sweeps on W from the basis V0 when
    ``stale`` (read on the host), else ``warm``. Returns (0.5 (P + P'), V)
    with P = V max(w, 0) V'."""
    w, V = jacobi_eigh(W, full if bool(stale) else warm, method, V0=V0)
    P = psd_reconstruct(w, V)
    return 0.5 * (P + P.transpose(-1, -2)), V


def min_max_eig_jacobi(X, sweeps: int = 8, method: str = "vec"):
    """(min, max) eigenvalue per block via Jacobi (for membership tests)."""
    w, _ = jacobi_eigh(X, sweeps, method)
    return torch.amin(w, dim=-1), torch.amax(w, dim=-1)


def psd_project_eigh(X):
    """PSD projection via ``torch.linalg.eigh`` (the "xla" backend)."""
    return psd_reconstruct(*torch.linalg.eigh(X))


@contextlib.contextmanager
def tf32_matmuls():
    """float32 products in TF32 inside the block (a no-op on the CPU)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# the float32 bits below a TF32 mantissa (10 of float32's 23 stay)
_TF32_LOW_BITS = (1 << 13) - 1


def _tf32_split(M):
    """M = hi + lo with hi representable in TF32 (M's low 13 mantissa bits
    cleared) and lo = M - hi exact in float32."""
    hi = (M.view(torch.int32) & ~_TF32_LOW_BITS).view(torch.float32)
    return hi, M - hi


def matmul_3xtf32(A, B):
    """A @ B in float32 from three TF32 products, hi(A) hi(B) + (hi(A)
    lo(B) + lo(A) hi(B)): about 21 bits of each operand, the counterpart on
    an H100 of the TPU's three bf16 passes (the JAX package's
    ``precision="high"``). Call it inside :func:`tf32_matmuls`."""
    Ah, Al = _tf32_split(A)
    Bh, Bl = _tf32_split(B)
    return Ah @ Bh + (Ah @ Bl + Al @ Bh)


def psd_project_polar(X, quintic_iters: int = 9, cubic_iters: int = 6,
                      tf32: bool = False, split=None):
    """PSD projection via the matrix sign function: Pi(X) = (X + |X|)/2 with
    |X| = X sign(X), the sign computed by Newton-Schulz on X/||X||_F: an
    aggressive quintic phase (3 matmuls a step), then the cubic polish
    (schedule of ``cosmo_tpu.ops.eigh.psd_project_polar``).

    ``tf32``: the mixed-precision loose phase (the JAX package's
    ``precision="high"``, three bf16 passes on a TPU): each float32 product
    is :func:`matmul_3xtf32`, three TF32 passes. One TF32 pass (JAX's
    "high" on a GPU) keeps 10 mantissa bits, and on an H100 it floors the
    relative residuals of ``block_sdp(8, 256, 256)`` at ~3e-3, above the
    loose phase's switch (1e-3), so the phase never ends (PERF.md §6),
    as one bf16 pass does on the TPU (``cosmo_tpu.ops.projections:103-113``).
    Other types ignore the flag.

    ``split``: under a device mesh, a function that wraps a product so that
    its output rows are split over the ranks (``ops/shard.split_rows_mm``),
    for a bucket of fewer blocks than ranks."""
    wrap = split if split is not None else (lambda mm: mm)
    if not (tf32 and X.dtype == torch.float32):
        return _polar(X, quintic_iters, cubic_iters, wrap(torch.matmul))
    with tf32_matmuls():
        return _polar(X, quintic_iters, cubic_iters, wrap(matmul_3xtf32))


def _polar(X, quintic_iters, cubic_iters, mm):
    a, bq, cq = 3.4445, -4.7750, 2.0315
    nrm = torch.sqrt(torch.sum(X * X, dim=(-2, -1), keepdim=True))
    Z = X / torch.clamp(nrm, min=torch.finfo(X.dtype).tiny)
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)

    def sym(M):
        return 0.5 * (M + M.transpose(-1, -2))

    for _ in range(quintic_iters):
        Y = mm(Z, Z)
        Z = sym(mm(Z, a * eye + bq * Y + cq * mm(Y, Y)))
    for _ in range(cubic_iters):
        Z = sym(1.5 * Z - 0.5 * mm(mm(Z, Z), Z))
    return sym(0.5 * (X + mm(X, Z)))
