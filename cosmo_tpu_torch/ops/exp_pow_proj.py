"""Exponential- and power-cone projections: the wrappers that launch the
hand-written CUDA kernels (``csrc/exp_pow_proj.cu``, persistent warps
that split rows by case, queue the case-4 rows and refill lanes from the
queue, one Newton step a pass: the exp cone's step machine with a cone's
lanes evaluating ahead, the pow cone's Newton with alpha's constants
computed once a warp) on a CUDA tensor and run the plain PyTorch version
(:mod:`.exp_pow`) on a CPU tensor.

The kernel is not a port of a TPU kernel: the JAX package projects these
cones with one ``jax.vmap`` of nested ``lax.while_loop``
(``cosmo_tpu/ops/exp_pow.py:133``, ``:213``), which XLA runs as a loop on
the device with a predicate a lane. PyTorch has no loop on the device, and
the plain version's masked steps cost a host read each, so the kernel is
that loop's counterpart: it computes the same function lane for lane.

* :func:`project_exp` — K_exp, or K_exp^* where ``is_dual``; counts its
  launches in ``project_exp.launches``;
* :func:`project_pow` — K_pow(alpha) or its dual; ``project_pow.launches``.

There is no fallback: on a CUDA tensor the kernel is built at first use
(``cuda_build.exp_pow_library``) and launched, and a failed build or
launch raises.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .exp_pow import project_exp_plain, project_pow_plain


# the C entries of each loaded library, looked up once: library -> {(family,
# dtype): entry}; keyed by the library, which profile_exp swaps
_ENTRIES: dict = {}


def _entry(prefix, dtype):
    lib = cuda_build.exp_pow_library()
    entries = _ENTRIES.get(lib)
    if entries is None:
        entries = _ENTRIES[lib] = {
            (family, t): getattr(lib, f"{family}_{sfx}")
            for family in ("exp_proj", "pow_proj")
            for t, sfx in ((torch.float32, "f32"), (torch.float64, "f64"))}
    return entries[prefix, dtype]


def _launch(prefix, V, alpha, is_dual, tol, max_iter):
    """One launch of the C entry ``<prefix>_<f32|f64>`` on the rows of
    ``V`` [N, 3] on the current stream (``alpha`` None for exp). Raises on
    input the kernel does not take and when the launch reports an error.
    A bool ``is_dual`` goes to the kernel as its bytes (a view, no copy),
    so that a projection is one device operation."""
    if V.device.type != "cuda":
        raise ValueError(f"{prefix} needs a CUDA tensor, got {V.device}")
    if V.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{prefix} takes float32/float64, got {V.dtype}")
    if V.dim() != 2 or V.shape[1] != 3:
        raise ValueError(f"{prefix} takes [N, 3] rows, got {tuple(V.shape)}")
    rows = (("is_dual", is_dual), ("tol", tol)) + (() if alpha is None else (("alpha", alpha),))
    for what, t in rows:
        if t.shape != (V.shape[0],) or t.device != V.device:
            raise ValueError(f"{prefix}: {what} must be [N] on {V.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    V = V.contiguous()
    flags = is_dual.view(torch.uint8) if is_dual.dtype == torch.bool else is_dual.to(torch.uint8)
    per_row = [] if alpha is None else [alpha.to(V.dtype).contiguous()]
    per_row += [flags.contiguous(), tol.to(V.dtype).contiguous()]
    out = torch.empty_like(V)
    err = _entry(prefix, V.dtype)(
        V.data_ptr(), *(t.data_ptr() for t in per_row), out.data_ptr(), V.shape[0],
        int(max_iter), torch.cuda.current_stream(V.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{prefix} kernel launch failed: CUDA error {err} "
                           f"(N={V.shape[0]}, {V.dtype})")
    return out


def exp_proj_cuda(V, is_dual, tol, max_iter: int):
    """Launch the exp kernel on the rows of ``V`` [N, 3] (a CUDA tensor) on
    the current stream; ``is_dual`` [N] bool, ``tol`` [N]. Does not
    count."""
    return _launch("exp_proj", V, None, is_dual, tol, max_iter)


def pow_proj_cuda(V, alpha, is_dual, tol, max_iter: int):
    """Launch the pow kernel on the rows of ``V`` [N, 3] (a CUDA tensor);
    ``alpha`` [N], ``is_dual`` [N] bool, ``tol`` [N]. Does not count."""
    return _launch("pow_proj", V, alpha, is_dual, tol, max_iter)


def project_exp(V, is_dual, tol, max_iter: int = 100):
    """Project the rows of V [N, 3] onto K_exp (K_exp^* where ``is_dual``):
    on a CUDA device one launch of the kernel (counted), on the CPU the
    plain version."""
    if V.shape[0] == 0:
        return V
    if V.device.type == "cpu":
        return project_exp_plain(V, is_dual, tol, max_iter)
    out = exp_proj_cuda(V, is_dual, tol, max_iter)
    project_exp.launches += 1
    return out


def project_pow(V, alpha, is_dual, tol, max_iter: int = 20):
    """Project the rows of V [N, 3] onto K_pow(alpha) (its dual where
    ``is_dual``): on a CUDA device one launch of the kernel (counted), on
    the CPU the plain version."""
    if V.shape[0] == 0:
        return V
    if V.device.type == "cpu":
        return project_pow_plain(V, alpha, is_dual, tol, max_iter)
    out = pow_proj_cuda(V, alpha, is_dual, tol, max_iter)
    project_pow.launches += 1
    return out


project_exp.launches = 0
project_pow.launches = 0
