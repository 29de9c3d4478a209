"""Batched Jacobi PSD projection: the round-robin hand-written CUDA kernel,
its plain PyTorch version, and the wrapper that picks a kernel.

The kernel (``csrc/jacobi_proj.cu``) replaces the TPU kernel
``cosmo_tpu/ops/pallas_eigh.py::_proj_kernel``: the round-robin Jacobi
schedule on each k x k matrix of a [B, k, k] stack, each round's k/2
disjoint rotations at once, followed by the fused reconstruction
V max(diag X, 0) V'. It shares its design (``csrc/jacobi_rounds.cuh``) with
the slot-rotation kernel of :mod:`.jacobi_proj_rr`; the source notes say
what bounds them on an H100 and what the design does about it.

* :func:`psd_project_pallas` — the wrapper (named after the function it
  replaces), with the reference's switches read as ``pallas_eigh.py`` reads
  them: ``COSMO_TPU_DISABLE_PALLAS`` sends every side to
  ``torch.linalg.eigh``; ``COSMO_TPU_PALLAS_RR`` selects the slot-rotation
  kernel (:mod:`.jacobi_proj_rr`); otherwise the round-robin kernel runs. A
  tensor on a CUDA device goes to the kernel, built from the repository's
  sources with ``nvcc`` at first use (one library for both kernels,
  ``cuda_build.jacobi_library``); a tensor on the CPU goes to the
  kernel's plain version. The round-robin kernel counts its launches in
  ``psd_project_pallas.launches``, the slot-rotation one in
  ``jacobi_proj_rr.psd_project_rr.launches``.
* :func:`psd_project_jacobi_plain` — the kernel's algorithm in PyTorch,
  applying each round's k/2 disjoint rotations at once (the rotations of
  the TPU kernel's pair-by-pair order; only the rounding differs). The CPU
  tests hold it to ``cosmo_tpu.ops.eigh.psd_project_jacobi`` and
  ``chip_smoke.py`` holds the kernel to it on the card.

Sides the kernels do not take (odd k, k < 4, k > 48) go to
``torch.linalg.eigh``, the reference wrapper's own domain rule
(``pallas_eigh.py:257-266``).
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from . import cuda_build
from . import eigh as eigh_mod
from . import jacobi_proj_rr
from .eigh import kernel_takes


def pair_schedule(k: int, dtype=np.uint8) -> np.ndarray:
    """The round-robin pair schedule flattened to [p0, q0, p1, q1, ...]
    (``cosmo_tpu/ops/pallas_eigh.py::_pair_schedule``), as uint8: the
    kernel's shared-memory body (k > 16) reads it; its register body
    computes the same rounds at compile time. ``dtype=np.uint16`` gives
    the table of the large-side kernel (``csrc/jacobi_eig_large.cu``).
    Raises ValueError when a label does not fit the type (k <= 256 for
    uint8)."""
    limit = int(np.iinfo(dtype).max) + 1
    if k > limit:
        raise ValueError(f"a {np.dtype(dtype).name} pair table holds the labels of "
                         f"sides k <= {limit}, got k = {k}")
    flat = []
    for p_arr, q_arr in eigh_mod._round_robin_rounds(k):
        for p, q in zip(p_arr, q_arr):
            flat.extend((int(p), int(q)))
    return np.asarray(flat, dtype=dtype)


@lru_cache(maxsize=None)
def _schedule_on(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pair_schedule(k), device=device)


def psd_project_jacobi_plain(X: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same round-robin Jacobi with
    the same guards and per-sweep symmetrization, a round's disjoint
    rotations applied at once (ops/eigh.py)."""
    return eigh_mod.psd_project_jacobi(X, sweeps)


def jacobi_proj_cuda(X: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Launch the kernel on ``X`` [B, k, k] (a contiguous float32/float64
    CUDA tensor, kernel_takes(k)) on the current stream. Does not count."""
    if X.device.type != "cuda":
        raise ValueError(f"jacobi_proj_cuda needs a CUDA tensor, got {X.device}")
    return cuda_build.launch_jacobi(cuda_build.jacobi_library(), "jacobi_proj", X,
                                    _schedule_on(X.shape[-1], X.device), sweeps)


def selected_kernel() -> str:
    """What :func:`psd_project_pallas` runs for a side the kernels take,
    under the current environment: "eigh", "jacobi_proj_rr" or
    "jacobi_proj"."""
    if os.environ.get("COSMO_TPU_DISABLE_PALLAS"):
        return "eigh"
    return "jacobi_proj_rr" if os.environ.get("COSMO_TPU_PALLAS_RR") else "jacobi_proj"


def psd_project_pallas(X: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """PSD-project a stack [B, k, k] with a Jacobi kernel: on a CUDA device
    the hand-written kernel (one launch, counted), on the CPU its plain
    version. Sides outside the kernels' domain, and every side under
    ``COSMO_TPU_DISABLE_PALLAS``, go to ``torch.linalg.eigh`` on either
    device."""
    if os.environ.get("COSMO_TPU_DISABLE_PALLAS") or not kernel_takes(X.shape[-1]):
        return eigh_mod.psd_project_eigh(X)
    if os.environ.get("COSMO_TPU_PALLAS_RR"):
        return jacobi_proj_rr.psd_project_rr(X, sweeps)
    if X.device.type == "cpu":
        return psd_project_jacobi_plain(X, sweeps)
    out = jacobi_proj_cuda(X, sweeps)
    psd_project_pallas.launches += 1
    return out


psd_project_pallas.launches = 0
