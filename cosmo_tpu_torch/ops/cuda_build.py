"""Build and load the hand-written CUDA kernels of this package.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled for sm_90a with ``nvcc`` at first use into ``cosmo_tpu_torch/_build/``
(gitignored) and loaded with ctypes; nothing is built when a module is
imported. The library's name carries a hash of its source and flags, so an
edited source never loads a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the side limits both Jacobi kernels take (pallas_eigh.py:257-266)
KERNEL_MIN_SIDE = 4
KERNEL_MAX_SIDE = 48


def kernel_takes(k: int) -> bool:
    """The reference wrapper's domain rule: even k in [4, 48]."""
    return k % 2 == 0 and KERNEL_MIN_SIDE <= k <= KERNEL_MAX_SIDE


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives."""
    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:12]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` for sm_90a unless it is already built. Raises if
    nvcc fails. The compiler's ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside the library with the suffix ``.log``."""
    so = library_path(source)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {source.name} failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_jacobi(source: Path, prefix: str) -> ctypes.CDLL:
    """Build and load a Jacobi projection kernel whose C entries are
    ``<prefix>_f32`` and ``<prefix>_f64``, both
    ``int f(const T* x, T* out, const uint8_t* pairs, int B, int k,
    int sweeps, void* stream)`` returning ``cudaGetLastError()``."""
    lib = ctypes.CDLL(str(build(source)))
    for fn in (getattr(lib, f"{prefix}_f32"), getattr(lib, f"{prefix}_f64")):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch_jacobi(lib: ctypes.CDLL, prefix: str, X: torch.Tensor,
                  pairs: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Launch a kernel of :func:`load_jacobi` on ``X`` [B, k, k] (a
    contiguous float32/float64 CUDA tensor, ``kernel_takes(k)``) on the
    current stream; ``pairs`` is its uint8 pair table on the same device.
    Raises on any other input and when the launch reports an error."""
    if X.device.type != "cuda":
        raise ValueError(f"{prefix} needs a CUDA tensor, got {X.device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{prefix} takes float32/float64, got {X.dtype}")
    if X.dim() != 3 or X.shape[1] != X.shape[2] or not kernel_takes(X.shape[1]):
        raise ValueError(f"{prefix} takes [B, k, k] with even 4 <= k <= 48, "
                         f"got {tuple(X.shape)}")
    if not X.is_contiguous():
        raise ValueError(f"{prefix} needs a contiguous input")
    B, k, _ = X.shape
    out = torch.empty_like(X)
    if B == 0:
        return out
    fn = getattr(lib, f"{prefix}_f32" if X.dtype == torch.float32 else f"{prefix}_f64")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(X.data_ptr(), out.data_ptr(), pairs.data_ptr(), B, k, int(sweeps),
             stream)
    if err != 0:
        raise RuntimeError(f"{prefix} kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, {X.dtype})")
    return out
