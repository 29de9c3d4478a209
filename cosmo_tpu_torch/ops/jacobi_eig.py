"""The amortized PSD projection: the warm-started Jacobi kernel, its plain
PyTorch version, and the wrapper the projection calls.

``cosmo_tpu.ops.eigh.psd_project_amortized`` carries each PSD bucket's
eigenbasis across ADMM iterations: it rotates W = V'XV in the
re-orthonormalised basis, then runs 2 Jacobi sweeps from it, or the full
sweeps when a block's off-diagonal mass says the basis went stale. The
sweep count is a traced scalar of a ``lax.fori_loop``. Here the torch part
(``eigh.amortized_rotate``) leaves the stale flag on the device, and the
kernel (``csrc/jacobi_eig.cu``, the ``kEig`` instantiation of the design of
``csrc/jacobi_rounds.cuh``) reads it there: the projection adds no host
read.

* :func:`psd_project_amortized` — the wrapper: on a CUDA device the torch
  rotation and one counted kernel launch; on the CPU the plain version
  ``eigh.psd_project_amortized``. Launches count in
  ``psd_project_amortized.launches`` by (k, dtype name); the kernel itself
  tallies its full-sweep launches on the device (:func:`full_sweep_count`
  reads the tally once).
* ``jacobi_eig_plain`` (``eigh.jacobi_eig_plain``) — the kernel's function
  in PyTorch: the Jacobi from V0 with the sweep count read on the host,
  then 0.5 (P + P'). The CPU tests hold it to the JAX function;
  ``chip_smoke.py`` holds the kernel to it on the card.

The kernel takes the sides of ``eigh.kernel_takes`` (even 4..48); a
CUDA tensor of another side, type or layout raises, and a build or launch
error raises: nothing falls back.
"""
from __future__ import annotations

from collections import Counter
from functools import lru_cache

import torch

from . import cuda_build
from . import eigh as eigh_mod
from .eigh import jacobi_eig_plain, kernel_takes  # noqa: F401
from .jacobi_proj import pair_schedule


@lru_cache(maxsize=None)
def _schedule_on(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pair_schedule(k), device=device)


def _check(name, T, like):
    if T.device != like.device or T.dtype != like.dtype or T.shape != like.shape:
        raise ValueError(f"jacobi_eig: {name} must match W's device, type and shape, "
                         f"got {T.device} {T.dtype} {tuple(T.shape)}")
    if not T.is_contiguous():
        raise ValueError(f"jacobi_eig: {name} must be contiguous")


def jacobi_eig_cuda(W, V0, stale, warm: int, full: int, n_full=None):
    """Launch the kernel on ``W`` and ``V0`` [B, k, k] (contiguous
    float32/float64 CUDA tensors, kernel_takes(k)) on the current stream,
    with ``stale`` a 0-d bool CUDA tensor; ``n_full``, an int32 CUDA tensor
    of one element, counts the launches that ran the full sweeps (on the
    device). Returns (P, V). Does not count launches."""
    if W.device.type != "cuda":
        raise ValueError(f"jacobi_eig_cuda needs a CUDA tensor, got {W.device}")
    if W.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"jacobi_eig takes float32/float64, got {W.dtype}")
    if W.dim() != 3 or W.shape[1] != W.shape[2] or not kernel_takes(W.shape[1]):
        raise ValueError(f"jacobi_eig takes [B, k, k] with even 4 <= k <= 48, "
                         f"got {tuple(W.shape)}")
    _check("W", W, W)
    _check("V0", V0, W)
    if stale.device != W.device or stale.dtype != torch.bool or stale.numel() != 1:
        raise ValueError("jacobi_eig: stale must be one bool on W's device")
    if n_full is not None and (n_full.device != W.device or n_full.dtype != torch.int32):
        raise ValueError("jacobi_eig: n_full must be an int32 tensor on W's device")
    B, k, _ = W.shape
    P, V = torch.empty_like(W), torch.empty_like(W)
    if B == 0:
        return P, V
    lib = cuda_build.jacobi_library()
    fn = lib.jacobi_eig_f32 if W.dtype == torch.float32 else lib.jacobi_eig_f64
    err = fn(W.data_ptr(), V0.data_ptr(), P.data_ptr(), V.data_ptr(),
             _schedule_on(k, W.device).data_ptr(), stale.data_ptr(), int(warm),
             int(full), None if n_full is None else n_full.data_ptr(), B, k,
             torch.cuda.current_stream(W.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, {W.dtype})")
    return P, V


# the device tallies of full-sweep launches, one int32 a device
_N_FULL: dict = {}


def _tally(device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if key not in _N_FULL:
        _N_FULL[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _N_FULL[key]


def full_sweep_count(device="cuda") -> int:
    """The kernel launches on ``device`` that ran the full sweeps since the
    last :func:`reset_counts` (one host read)."""
    return int(_tally(device).item())


def reset_counts():
    """Zero the launch counter and the device tallies of full sweeps."""
    psd_project_amortized.launches = Counter()
    for t in _N_FULL.values():
        t.zero_()


def psd_project_amortized(X, V_prev, warm_sweeps: int = 2, full_sweeps: int = 8):
    """The amortized PSD projection of a stack [B, k, k] from the carried
    basis ``V_prev``: on a CUDA device :func:`eigh.amortized_rotate` and one
    counted launch of the kernel, the stale flag never leaving the card; on
    the CPU the plain version :func:`eigh.psd_project_amortized`. Returns
    (P, V)."""
    if X.device.type == "cpu":
        return eigh_mod.psd_project_amortized(X, V_prev, warm_sweeps, full_sweeps)
    W, V0, stale = eigh_mod.amortized_rotate(X, V_prev)
    out = jacobi_eig_cuda(W, V0, stale, warm_sweeps, full_sweeps, _tally(X.device))
    psd_project_amortized.launches[(X.shape[-1], str(X.dtype).split(".")[-1])] += 1
    return out


psd_project_amortized.launches = Counter()
