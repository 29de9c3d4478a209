"""Batched Jacobi PSD projection: the hand-written CUDA kernel, its plain
PyTorch version and the wrapper that picks between them.

The kernel (``csrc/jacobi_proj.cu``) replaces the TPU kernel
``cosmo_tpu/ops/pallas_eigh.py::_proj_kernel``: the serial round-robin
Jacobi schedule on each k x k matrix of a [B, k, k] stack, followed by the
fused reconstruction V max(diag X, 0) V'. The source note there says what
bounds it on an H100 and what the design does about it.

* :func:`psd_project_pallas` — the wrapper (named after the function it
  replaces). A tensor on a CUDA device goes to the kernel, which is built
  from the repository's source with ``nvcc`` at first use; a tensor on the
  CPU goes to the plain version. It counts its kernel launches in
  ``psd_project_pallas.launches``.
* :func:`psd_project_jacobi_plain` — the same algorithm in PyTorch, applying
  each round's k/2 disjoint rotations at once (the angles are the serial
  schedule's; only the rounding order differs). The CPU tests hold it to
  ``cosmo_tpu.ops.eigh.psd_project_jacobi`` and ``chip_smoke.py`` holds the
  kernel to it on the card.

Sides the kernel does not take (odd k, k < 4, k > 48) go to
``torch.linalg.eigh``, the reference wrapper's own domain rule
(``pallas_eigh.py:257-266``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from . import eigh as eigh_mod

KERNEL_MIN_SIDE = 4
KERNEL_MAX_SIDE = 48

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "jacobi_proj.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the Jacobi projection kernel")
    return found


def library_path() -> Path:
    """Where the built kernel library lives; the name carries a hash of the
    source and flags, so an edited source never loads a stale build."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libjacobi_proj_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``csrc/jacobi_proj.cu`` for sm_90a unless this source is
    already built. Raises if nvcc fails. The compiler's ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside the library
    with the suffix ``.log``."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {SOURCE.name} failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.jacobi_proj_f32, lib.jacobi_proj_f64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pair_schedule(k: int) -> np.ndarray:
    """The round-robin pair schedule flattened to [p0, q0, p1, q1, ...]
    (``cosmo_tpu/ops/pallas_eigh.py::_pair_schedule``), as uint8."""
    flat = []
    for p_arr, q_arr in eigh_mod._round_robin_rounds(k):
        for p, q in zip(p_arr, q_arr):
            flat.extend((int(p), int(q)))
    return np.asarray(flat, dtype=np.uint8)


@lru_cache(maxsize=None)
def _schedule_on(k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pair_schedule(k), device=device)


def kernel_takes(k: int) -> bool:
    """The reference wrapper's domain rule: even k in [4, 48]."""
    return k % 2 == 0 and KERNEL_MIN_SIDE <= k <= KERNEL_MAX_SIDE


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
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"jacobi_proj_cuda takes float32/float64, got {X.dtype}")
    if X.dim() != 3 or X.shape[1] != X.shape[2] or not kernel_takes(X.shape[1]):
        raise ValueError(f"jacobi_proj_cuda takes [B, k, k] with even 4 <= k <= 48, "
                         f"got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError("jacobi_proj_cuda needs a contiguous input")
    B, k, _ = X.shape
    out = torch.empty_like(X)
    if B == 0:
        return out
    lib = _library()
    fn = lib.jacobi_proj_f32 if X.dtype == torch.float32 else lib.jacobi_proj_f64
    pairs = _schedule_on(k, X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(X.data_ptr(), out.data_ptr(), pairs.data_ptr(), B, k, int(sweeps),
             stream)
    if err != 0:
        raise RuntimeError(f"jacobi_proj kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, {X.dtype})")
    return out


def psd_project_pallas(X: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """PSD-project a stack [B, k, k] with the Jacobi kernel: on a CUDA
    device the hand-written kernel (one launch, counted), on the CPU its
    plain version. Sides outside the kernel's domain go to
    ``torch.linalg.eigh`` on either device."""
    k = X.shape[-1]
    if not kernel_takes(k):
        return eigh_mod.psd_project_eigh(X)
    if X.device.type == "cpu":
        return psd_project_jacobi_plain(X, sweeps)
    out = jacobi_proj_cuda(X, sweeps)
    psd_project_pallas.launches += 1
    return out


psd_project_pallas.launches = 0
