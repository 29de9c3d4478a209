"""Slot-rotation Jacobi PSD projection: the hand-written CUDA kernel, its
plain PyTorch version and its pair table.

The kernel (``csrc/jacobi_proj_rr.cu``) replaces the TPU kernel
``cosmo_tpu/ops/pallas_eigh.py::_proj_kernel_rr``. That kernel applies
each round's k/2 disjoint rotations at once at the slot pairs (2t, 2t+1)
and moves the data between rounds by the circle-method slot rotation
(``_slot_rotate``). :func:`pair_table` follows the slot rotation on the
host and records, for every round, the original indices that sit in each
slot pair; the plain version and the kernel's shared-memory body (k > 16)
apply the rotations at those indices, which is exact because a round's
rotations have disjoint support. The kernel's register body (k <= 16)
moves the rows by the same rotation and computes the table at compile time
(``csrc/jacobi_rounds.cuh``, shared with :mod:`.jacobi_proj`). The slot
rotation has period k - 1, so the layout is the identity again at each
sweep's end, where the symmetrization and the reconstruction see it.

* :func:`psd_project_rr` — the wrapper: the kernel for a CUDA tensor (one
  launch, counted in ``psd_project_rr.launches``), the plain version for a
  CPU tensor; sides outside even 4..48 go to ``torch.linalg.eigh``.
  ``jacobi_proj.psd_project_pallas`` sends here under
  ``COSMO_TPU_PALLAS_RR``.
* :func:`psd_project_jacobi_rr_plain` — the same rounds in PyTorch: each
  round's row updates, then column updates of X and V, at the table's
  pairs (ops/eigh.py with this schedule).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import cuda_build
from . import eigh as eigh_mod
from .eigh import kernel_takes


def _slot_rotate(labels: np.ndarray) -> np.ndarray:
    """The circle-method slot rotation of ``pallas_eigh._slot_rotate`` on a
    1-D slot array: slots [t0, b0, t1, b1, ...] with pairs (2i, 2i+1) become
    new_top = [t0, b0, t1 .. t_{H-2}], new_bot = [b1 .. b_{H-1}, t_{H-1}]."""
    H = labels.size // 2
    top, bot = labels[0::2], labels[1::2]
    out = np.empty_like(labels)
    out[0::2] = np.concatenate([top[:1], bot[:1], top[1:H - 1]])
    out[1::2] = np.concatenate([bot[1:H], top[H - 1:H]])
    return out


@lru_cache(maxsize=None)
def pair_table(k: int) -> np.ndarray:
    """uint8 [k-1, k/2, 2]: in round r, slot pair t holds the original
    indices (p, q) = table[r, t] — p at slot 2t, q at slot 2t+1, which
    fixes the sign of tau."""
    if not k % 2 == 0 or k < 4:
        raise ValueError(f"the slot-rotation schedule needs an even side >= 4, got {k}")
    labels = np.arange(k)
    table = np.empty((k - 1, k // 2, 2), np.uint8)
    for r in range(k - 1):
        table[r, :, 0] = labels[0::2]
        table[r, :, 1] = labels[1::2]
        labels = _slot_rotate(labels)
    return table


@lru_cache(maxsize=None)
def _table_on(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pair_table(k).reshape(-1), device=device)


def psd_project_jacobi_rr_plain(X: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the rounds of
    :func:`pair_table`, the guards of the reference and the per-sweep
    symmetrization, then V max(w, 0) V'."""
    table = pair_table(X.shape[-1])
    return eigh_mod.psd_project_jacobi(
        X, sweeps, rounds=[(t[:, 0], t[:, 1]) for t in table])


def jacobi_proj_rr_cuda(X: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Launch the kernel on ``X`` [B, k, k] (a contiguous float32/float64
    CUDA tensor, kernel_takes(k)) on the current stream. Does not count."""
    if X.device.type != "cuda":
        raise ValueError(f"jacobi_proj_rr_cuda needs a CUDA tensor, got {X.device}")
    return cuda_build.launch_jacobi(cuda_build.jacobi_library(), "jacobi_proj_rr", X,
                                    _table_on(X.shape[-1], X.device), sweeps)


def psd_project_rr(X: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """PSD-project a stack [B, k, k] with the slot-rotation Jacobi: the
    kernel on a CUDA device (one launch, counted), its plain version on
    the CPU; ``torch.linalg.eigh`` for sides outside even 4..48."""
    if not kernel_takes(X.shape[-1]):
        return eigh_mod.psd_project_eigh(X)
    if X.device.type == "cpu":
        return psd_project_jacobi_rr_plain(X, sweeps)
    out = jacobi_proj_rr_cuda(X, sweeps)
    psd_project_rr.launches += 1
    return out


psd_project_rr.launches = 0
