"""Timers of the Jacobi kernels, and this checkout's kernels against
another checkout's on one card.

    python -m cosmo_tpu_torch.kernel_timing --other DIR [--large]

DIR is the root of another checkout of the repository, for instance the
parent commit unpacked with ``git archive``. Each tree builds its own
kernel sources into its own ``_build``; every kernel is then timed on the
same inputs at the shapes of :data:`SHAPES`, in turns other, this, this,
other, with both :func:`launch_ms` and :func:`device_ms`. Each
``jacobi_proj`` and ``jacobi_proj_rr`` line says whether the two trees'
outputs are the same bits. ``jacobi_eig`` is the amortized projection of
(X, V_prev), warm (:func:`eig_case`: 2 sweeps) and stale (V_prev = I: the
full sweeps): a tree whose kernel takes (W, V0, stale) runs it after the
torch rotation (``eigh.amortized_rotate``), the path before the kernel
took the whole projection; the line gives the largest difference of the
two trees' P and V, and this tree's kernel's ``device_ms`` at 0 sweeps
(the rotation, the barrier and the reconstruction alone). With
``--large``, only the large sides of :data:`LARGE_SHAPES` in float64, warm
and stale (:func:`eig_case` after the torch rotation): the kernel this
tree's ``kernel_for`` names against the other tree's ``jacobi_eig_large``
(its C entry of W, V0 and stale), each with its torch reconstruction, in
the same turns, and ``torch.linalg.eigh`` + reconstruction (V = V0 Q, P =
V max(w, 0) V') timed beside them; each line says whether the two trees'
P and V are the same bits. Needs CUDA.
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
from .ops import eigh as E
from .ops import jacobi_proj as J
from .ops import jacobi_proj_rr as R

# (k, B): the main path's side at three stack sizes, and other sides
SHAPES = ((16, 512), (16, 2498), (16, 8540), (8, 2498), (32, 2498), (48, 2498))
# (k, B) of --large: 10h's and 10i's buckets
LARGE_SHAPES = ((640, 1), (768, 1))
SWEEPS = 8


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


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


def eig_case(B, k, warm, seed):
    """(X, W, V0) of one amortized projection in float64 numpy arrays, made
    from ``seed``: X a symmetric Gaussian stack; warm, V0 its eigenbasis
    turned by a random orthogonal matrix near I (angles ~0.01, and ~0.01
    sqrt(48 / k) above k = 48: a block's off-diagonal mass, which grows with
    k, stays a few percent of its energy, under the staleness rule's 9%) and
    W = V0' X V0 symmetrised; stale, V0 = I and W = X, X drawn again from
    the same generator until some block's off-diagonal mass exceeds the
    rule's 9% of its energy (at k = 2 a Gaussian block can fall under it;
    from k = 4 on the first draw is stale)."""
    rng = np.random.default_rng(seed)
    while True:
        G = rng.standard_normal((B, k, k))
        X = (G + G.swapaxes(1, 2)) / 2
        tot2 = (X * X).sum(axis=(1, 2))
        off2 = tot2 - (np.diagonal(X, axis1=1, axis2=2) ** 2).sum(axis=1)
        if warm or (off2 > 0.09 * tot2).any():
            break
    if warm:
        R = rng.standard_normal((B, k, k)) * 0.01 * min(1.0, np.sqrt(48 / k))
        R, _ = np.linalg.qr(np.eye(k) + (R - R.swapaxes(1, 2)))
        V0 = np.linalg.eigh(X)[1] @ R
        W = V0.swapaxes(1, 2) @ X @ V0
        W = (W + W.swapaxes(1, 2)) / 2
    else:
        V0, W = np.broadcast_to(np.eye(k), (B, k, k)), X
    return X, W, V0


def _launch_eig(lib, X, V0, pairs, sync, warm=2, full=SWEEPS):
    """A tree's ``jacobi_eig`` on (X, V0), ``warm`` and ``full`` sweeps: P
    and V stacked. A library whose entry takes (W, V0, stale)
    (12 arguments) gets the torch rotation first; ``sync`` is the fused
    kernel's three device ints (zero at first)."""
    B, k, _ = X.shape
    P, V = torch.empty_like(X), torch.empty_like(X)
    stale = torch.empty((), dtype=torch.bool, device=X.device)
    fn = lib.jacobi_eig_f32 if X.dtype == torch.float32 else lib.jacobi_eig_f64
    stream = torch.cuda.current_stream(X.device).cuda_stream
    if len(fn.argtypes) == 12:
        W, V0, stale = E.amortized_rotate(X, V0)
        err = fn(W.data_ptr(), V0.data_ptr(), P.data_ptr(), V.data_ptr(), pairs.data_ptr(),
                 stale.data_ptr(), warm, full, None, B, k, stream)
    else:
        err = fn(X.data_ptr(), V0.data_ptr(), P.data_ptr(), V.data_ptr(), pairs.data_ptr(),
                 stale.data_ptr(), sync.data_ptr(), warm, full, None, B, k, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig kernel launch failed: CUDA error {err}")
    return torch.cat((P, V))


def _launch_large(lib, W, V0, stale, pairs, warm=2, full=SWEEPS):
    """A tree's ``jacobi_eig_large`` C entry (W and V in global
    memory, a grid barrier a round) on (W, V0, stale), then the torch
    reconstruction: (P, V). ``pairs`` is its uint16 pair table on the
    card."""
    B, k, _ = W.shape
    w, V = W.new_empty((B, k)), torch.empty_like(W)
    scratch = W.new_empty((2, B, k, k))
    fn = lib.jacobi_eig_large_f32 if W.dtype == torch.float32 else lib.jacobi_eig_large_f64
    err = fn(W.data_ptr(), V0.data_ptr(), w.data_ptr(), V.data_ptr(), scratch.data_ptr(),
             pairs.data_ptr(), stale.data_ptr(), warm, full, None, B, k,
             torch.cuda.current_stream(W.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig_large kernel launch failed: CUDA error {err}")
    return E.sym_reconstruct(w, V), V


def large_main(other, smi):
    """--large: this tree's kernel at each side of LARGE_SHAPES (its
    ``kernel_for``) against the other tree's jacobi_eig_large, and eigh."""
    from .ops import jacobi_eig as JE

    device = torch.device("cuda")
    lib_other = _load(other, "jacobi_eig")
    print(smi)
    print("each case: launch_ms other (jacobi_eig_large), this (kernel_for's), this, other | "
          "device_ms the same | eigh + reconstruction launch_ms, device_ms | the two "
          "trees' P and V bit-identical")
    for k, B in LARGE_SHAPES:
        dtype = torch.float64
        route = JE.kernel_for(k, dtype)
        pairs = torch.as_tensor(J.pair_schedule(k, np.uint16).view(np.int16), device=device)
        for warm in (True, False):
            X, _, V_prev = eig_case(B, k, warm, seed=k * B + warm)
            X = torch.as_tensor(X, dtype=dtype, device=device)
            V_prev = torch.as_tensor(np.ascontiguousarray(V_prev), dtype=dtype, device=device)
            W, V0, stale = E.amortized_rotate(X, V_prev)
            W, V0 = W.contiguous(), V0.contiguous()
            calls = {"other": lambda: _launch_large(lib_other, W, V0, stale, pairs),
                     "this": lambda: JE.LAUNCHERS[route](W, V0, stale, 2, SWEEPS)}
            launch, dev, outs = [], [], {}
            for tree in ("other", "this", "this", "other"):
                launch.append(launch_ms(calls[tree], 5))
                dev.append(device_ms(calls[tree], 3))
                outs[tree] = calls[tree]()
            same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"]))

            def library():
                w, Q = torch.linalg.eigh(W)
                V = V0 @ Q
                return V @ (torch.clamp(w, min=0.0)[:, :, None] * V.transpose(1, 2)), V

            print(f"k={k} B={B} float64 {'warm' if warm else 'stale'} ({route}) | "
                  + " ".join(f"{t:.4f}" for t in launch) + " | "
                  + " ".join(f"{t:.4f}" for t in dev)
                  + f" | eigh {launch_ms(library, 5):.4f} {device_ms(library, 3):.4f}"
                  f" | same bits {same}", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", required=True, help="root of the other checkout")
    parser.add_argument("--large", action="store_true",
                        help="only the large sides (LARGE_SHAPES) against the other "
                             "tree's jacobi_eig_large")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a CUDA device")
    other = _other_cuda_build(Path(args.other).resolve())
    smi = card()
    if args.large:
        return large_main(other, smi)
    kernels = {}
    for name, tables in (("jacobi_proj", J._schedule_on), ("jacobi_proj_rr", R._table_on),
                         ("jacobi_eig", J._schedule_on)):
        for tree, builder in (("other", other), ("this", cuda_build)):
            kernels[tree, name] = (builder, _load(builder, name), tables)
    print(smi)
    print("each kernel: launch_ms other, this, this, other | device_ms the same | "
          "outputs of the two trees bit-identical (jacobi_eig: their largest difference)")
    device = torch.device("cuda")
    sync = {tree: torch.zeros(3, dtype=torch.int32, device=device)
            for tree in ("other", "this")}
    for k, B in SHAPES:
        for dtype in (torch.float32, torch.float64):
            G = np.random.default_rng(k * B).standard_normal((B, k, k))
            X = torch.as_tensor((G + G.swapaxes(1, 2)) / 2, dtype=dtype, device=device)
            line = f"k={k} B={B} {str(dtype).split('.')[1]}"
            for name in ("jacobi_proj", "jacobi_proj_rr"):
                launch, dev, outs = [], [], {}
                for tree in ("other", "this", "this", "other"):
                    builder, lib, tables = kernels[tree, name]
                    pairs = tables(k, device)

                    def fn():
                        return builder.launch_jacobi(lib, name, X, pairs, SWEEPS)

                    reps = 10 if k >= 32 else 20
                    launch.append(launch_ms(fn, reps))
                    dev.append(device_ms(fn, reps))
                    outs[tree] = fn()
                line += (f" | {name} " + " ".join(f"{t:.4f}" for t in launch)
                         + " | " + " ".join(f"{t:.4f}" for t in dev)
                         + f" | same bits {torch.equal(outs['this'], outs['other'])}")
            print(line, flush=True)
            for warm in (True, False):
                Xw, _, V0 = eig_case(B, k, warm, seed=k * B + warm)
                Xw = torch.as_tensor(Xw, dtype=dtype, device=device)
                V0 = torch.as_tensor(np.ascontiguousarray(V0), dtype=dtype, device=device)
                launch, dev, outs = [], [], {}
                for tree in ("other", "this", "this", "other"):
                    _, lib, tables = kernels[tree, "jacobi_eig"]
                    pairs = tables(k, device)

                    def fn():
                        return _launch_eig(lib, Xw, V0, pairs, sync[tree])

                    reps = 10 if k >= 32 else 20
                    launch.append(launch_ms(fn, reps))
                    dev.append(device_ms(fn, reps))
                    outs[tree] = fn()
                diff = (outs["this"] - outs["other"]).abs().max().item()
                _, lib, tables = kernels["this", "jacobi_eig"]
                bare = device_ms(lambda: _launch_eig(lib, Xw, V0, tables(k, device),
                                                     sync["this"], 0, 0), 20)
                print(f"k={k} B={B} {str(dtype).split('.')[1]} "
                      f"{'warm' if warm else 'stale'} | jacobi_eig "
                      + " ".join(f"{t:.4f}" for t in launch) + " | "
                      + " ".join(f"{t:.4f}" for t in dev)
                      + f" | max |P, V - other's| {diff:.3e} | this tree at 0 sweeps "
                      f"(device_ms) {bare:.4f}", flush=True)


if __name__ == "__main__":
    main()
