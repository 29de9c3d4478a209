"""Build and load the hand-written CUDA kernels of this package.

The kernels are ``csrc/*.cu`` files with a plain C interface, in two
libraries: the Jacobi kernels' (:func:`jacobi_library`) and the exp/pow
cone projection's (:func:`exp_pow_library`). Each is compiled for sm_90a
with ``nvcc`` at first use into ``cosmo_tpu_torch/_build/`` (gitignored),
one ``nvcc`` per source, all started together, then linked, and loaded
with ctypes; nothing is built when a module is imported (:func:`build_all`
builds both libraries at once). A library's name carries a hash of its
sources, the headers they include from ``csrc/`` and the flags, so an
edited source or header never loads a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the Jacobi kernels' library: the round-robin and the slot-rotation
# schedules' C entries, and the shared-memory body both use
JACOBI_SOURCES = ("jacobi_proj.cu", "jacobi_proj_rr.cu", "jacobi_smem.cu")
JACOBI_ENTRIES = ("jacobi_proj", "jacobi_proj_rr")
# the exp/pow cone projection's library: one source, one entry a family
EXP_POW_SOURCES = ("exp_pow_proj.cu",)

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(source: Path) -> list[Path]:
    """``source`` and every file it includes with ``#include "..."`` from
    its own directory, recursively, each once."""
    seen, todo = [], [source]
    while todo:
        path = todo.pop(0)
        if path in seen or not path.is_file():
            continue
        seen.append(path)
        todo.extend(path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes()))
    return seen


def library_path(sources: Sequence[Path], name: str) -> Path:
    """Where the library ``name`` built from ``sources`` lives: its name
    carries a hash of the sources, of the headers they include and of the
    flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for source in sources:
        for path in _sources(source):
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(sources: Sequence[Path], name: str) -> Path:
    """Compile ``sources`` for sm_90a into the one library ``name`` unless
    it is built: one ``nvcc -c`` per source, all started together, then
    one link. Raises if nvcc fails. The compiler's ``-Xptxas -v`` reports
    (registers, shared memory, spills) are kept beside the library with
    the suffix ``.log``."""
    so = library_path(sources, name)
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    try:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for src, obj in zip(sources, objs)]
        reports = [proc.communicate()[0] for proc in procs]
        so.with_suffix(".log").write_text("".join(reports))
        for src, proc, report in zip(sources, procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"building {src.name} failed:\n{report}")
        tmp = so.with_suffix(f".{tag}.tmp")
        link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {so.name} failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def build_jacobi() -> Path:
    """Compile the Jacobi kernels' library unless it is built."""
    return build([CSRC / name for name in JACOBI_SOURCES], "jacobi")


@lru_cache(maxsize=None)
def jacobi_library() -> ctypes.CDLL:
    """Build and load the Jacobi kernels' library. Its C entries
    ``<prefix>_f32`` and ``<prefix>_f64``, for each prefix of
    :data:`JACOBI_ENTRIES`, are ``int f(const T* x, T* out, const uint8_t*
    pairs, int B, int k, int sweeps, void* stream)`` returning
    ``cudaGetLastError()``."""
    lib = ctypes.CDLL(str(build_jacobi()))
    for prefix in JACOBI_ENTRIES:
        for fn in (getattr(lib, f"{prefix}_f32"), getattr(lib, f"{prefix}_f64")):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def launch_jacobi(lib: ctypes.CDLL, prefix: str, X: torch.Tensor,
                  pairs: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Launch a kernel of :func:`jacobi_library` on ``X`` [B, k, k] (a
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


def build_exp_pow() -> Path:
    """Compile the exp/pow cone projection's library unless it is built."""
    return build([CSRC / name for name in EXP_POW_SOURCES], "exp_pow")


@lru_cache(maxsize=None)
def exp_pow_library() -> ctypes.CDLL:
    """Build and load the exp/pow cone projection's library. Its C entries
    ``exp_proj_<f32|f64>(const T* v, const uint8_t* is_dual, const T* tol,
    T* out, int n, int max_iter, void* stream)`` and ``pow_proj_<f32|f64>``
    (the same with ``const T* alpha`` after ``v``) return
    ``cudaGetLastError()``."""
    lib = ctypes.CDLL(str(build_exp_pow()))
    p, i = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "f64"):
        getattr(lib, f"exp_proj_{t}").argtypes = [p, p, p, p, i, i, p]
        getattr(lib, f"pow_proj_{t}").argtypes = [p, p, p, p, p, i, i, p]
        getattr(lib, f"exp_proj_{t}").restype = i
        getattr(lib, f"pow_proj_{t}").restype = i
    return lib


def build_all() -> list[Path]:
    """Compile both libraries unless they are built, every source's
    ``nvcc`` started together (one thread a library)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        return list(pool.map(lambda fn: fn(), (build_jacobi, build_exp_pow)))
