"""Timers of the Jacobi kernels, and this checkout's kernels against
another checkout's on one card.

    python -m cosmo_tpu_torch.kernel_timing --other DIR

DIR is the root of another checkout of the repository, for instance the
parent commit unpacked with ``git archive``. Each tree builds its own
kernel sources into its own ``_build``; every kernel is then timed on the
same inputs at the shapes of :data:`SHAPES`, in turns other, this, this,
other, with both :func:`launch_ms` and :func:`device_ms`, and each line
says whether the two trees' outputs are the same bits: ``jacobi_proj``,
``jacobi_proj_rr`` and ``jacobi_eig`` (from V0 = I, stale). Needs CUDA.
"""
from __future__ import annotations

import argparse
import importlib.machinery
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .ops import cuda_build
from .ops import jacobi_proj as J
from .ops import jacobi_proj_rr as R

# (k, B): the main path's side at three stack sizes, and other sides
SHAPES = ((16, 512), (16, 2498), (16, 8540), (8, 2498), (32, 2498), (48, 2498))
SWEEPS = 8


def launch_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of one ``fn()`` each, after one
    warm-up: the ``ms`` of ``chip_smoke.py``'s kernels line. For a short
    call it includes part of the host's launch cost."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, rounds=3):
    """Device time of one ``fn()``: after a warm-up, the median over
    ``rounds`` of the CUDA-event time of ``reps`` calls in a row, divided
    by ``reps``. A device-side sleep queued first keeps the card busy
    while the host enqueues the calls, so the host's launch cost stays out
    of a call that enqueues work without waiting for the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _other_cuda_build(root: Path):
    """The other checkout's ``ops/cuda_build.py``, loaded from its file as a
    module of a package ``_other_ops`` over that checkout's ``ops/``, so
    that its relative imports (``from .eigh import ...``) load the other
    checkout's modules and not the package's own."""
    ops = root / "cosmo_tpu_torch" / "ops"
    package = importlib.machinery.ModuleSpec("_other_ops", None, is_package=True)
    package.submodule_search_locations = [str(ops)]
    sys.modules["_other_ops"] = importlib.util.module_from_spec(package)
    spec = importlib.util.spec_from_file_location("_other_ops.cuda_build",
                                                  ops / "cuda_build.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _load(builder, name):
    """Kernel ``name``'s library in a checkout: one library for both
    kernels, or (an older checkout) one source and library each."""
    if hasattr(builder, "jacobi_library"):
        return builder.jacobi_library()
    return builder.load_jacobi(builder.CSRC / f"{name}.cu", name)


def _launch_eig(lib, X, pairs):
    """jacobi_eig of a tree's library on W = X from V0 = I with the stale
    flag set (``SWEEPS`` sweeps): P and V stacked."""
    B, k, _ = X.shape
    P, V = torch.empty_like(X), torch.empty_like(X)
    V0 = torch.eye(k, dtype=X.dtype, device=X.device).expand(B, k, k).contiguous()
    stale = torch.ones((), dtype=torch.bool, device=X.device)
    fn = lib.jacobi_eig_f32 if X.dtype == torch.float32 else lib.jacobi_eig_f64
    err = fn(X.data_ptr(), V0.data_ptr(), P.data_ptr(), V.data_ptr(), pairs.data_ptr(),
             stale.data_ptr(), 2, SWEEPS, None, B, k,
             torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig kernel launch failed: CUDA error {err}")
    return torch.cat((P, V))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a CUDA device")
    other = _other_cuda_build(Path(args.other).resolve())
    kernels = {}
    for name, tables in (("jacobi_proj", J._schedule_on), ("jacobi_proj_rr", R._table_on),
                         ("jacobi_eig", J._schedule_on)):
        for tree, builder in (("other", other), ("this", cuda_build)):
            kernels[tree, name] = (builder, _load(builder, name), tables)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    print("each kernel: launch_ms other, this, this, other | device_ms the same | "
          "outputs of the two trees bit-identical")
    device = torch.device("cuda")
    for k, B in SHAPES:
        for dtype in (torch.float32, torch.float64):
            G = np.random.default_rng(k * B).standard_normal((B, k, k))
            X = torch.as_tensor((G + G.swapaxes(1, 2)) / 2, dtype=dtype, device=device)
            line = f"k={k} B={B} {str(dtype).split('.')[1]}"
            for name in ("jacobi_proj", "jacobi_proj_rr", "jacobi_eig"):
                launch, dev, outs = [], [], {}
                for tree in ("other", "this", "this", "other"):
                    builder, lib, tables = kernels[tree, name]
                    pairs = tables(k, device)

                    def fn():
                        if name == "jacobi_eig":
                            return _launch_eig(lib, X, pairs)
                        return builder.launch_jacobi(lib, name, X, pairs, SWEEPS)

                    reps = 10 if k >= 32 else 20
                    launch.append(launch_ms(fn, reps))
                    dev.append(device_ms(fn, reps))
                    outs[tree] = fn()
                line += (f" | {name} " + " ".join(f"{t:.4f}" for t in launch)
                         + " | " + " ".join(f"{t:.4f}" for t in dev)
                         + f" | same bits {torch.equal(outs['this'], outs['other'])}")
            print(line, flush=True)


if __name__ == "__main__":
    main()
