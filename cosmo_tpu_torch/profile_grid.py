"""Where a round of the grid kernel goes, on one card.

    python -m cosmo_tpu_torch.profile_grid [--ctas 32,64,96,128]

Builds ``csrc/jacobi_eig_grid.cu`` once more with ``-DJACOBI_GRID_PROFILE``
(``cuda_build.variant_library``) and runs it on the grid kernel's
paths' buckets ([1, 640] and [1, 768] float64, warm and stale, made as
``kernel_timing.eig_case`` makes them) at each CTA count of ``--ctas``. For
each it prints, from the clock of thread 0 of the first CTA, the
microseconds a round spends waiting for the other CTAs' flags, computing
the angles (with the entering columns and a sweep's symmetrisation),
turning its boundary slots' tiles beside the other slots' mailbox entries,
writing the boundary slots' entries and leaving columns and publishing its
flag, turning its other tiles, and planning the next round (summed over the
rounds, divided by them), then the milliseconds the CTA waits at the end
for its V replay's warps (their lag behind the W phase) and the whole
launch's; from the global timer of 64 rounds, the spread of the CTAs'
publishing times and the time from the last publication to a CTA seeing
it; beside them the shipped kernel's device time
(``kernel_timing.device_ms``) at that CTA count, whose outputs must be the
profiled build's bits. The profiled build reads the clock a few times a
round; its parts are a breakdown, not the kernel's time. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from .kernel_timing import card, device_ms, eig_case
from .ops import cuda_build
from .ops import eigh as E
from .ops import jacobi_eig as JE

SHAPES = ((640, 1), (768, 1))
PARTS = ("wait", "angles", "boundary", "flag", "tiles", "plans")
# the profiled build's stamps (csrc/jacobi_eig_grid.cu, g_grid_stamps)
STAMP_CTAS, STAMP_ROUNDS = 128, 64


def profiled(lib, W, V0, stale, ctas, warm=2, full=8):
    """One launch of the profiled build: (P, V, {part: us a round}, the
    replay's lag in ms, launch ms)."""
    w, V = JE.launch_grid(lib, W, V0, stale, warm, full, None, ctas)
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * (9 + 2 * STAMP_CTAS * STAMP_ROUNDS))()
    if lib.jacobi_eig_grid_profile(out) != 0:
        raise RuntimeError("reading the grid kernel's profile failed")
    stamps = np.array(out[9:], dtype=np.int64).reshape(2, STAMP_CTAS, STAMP_ROUNDS)[:, :ctas]
    per_us = 1e3 / out[8]  # cycles to microseconds (out[8] is the clock in kHz)
    rounds = max(out[7], 1)
    parts = {name: out[n] * per_us / rounds for n, name in enumerate(PARTS)}
    lag = (out[6] - sum(out[n] for n in range(len(PARTS)))) * per_us / 1e3
    return E.sym_reconstruct(w, V), V, parts, lag, out[6] * per_us / 1e3, spread(stamps)


def spread(stamps):
    """From the global timer's stamps of 64 rounds: the median over the
    rounds of the spread of the CTAs' publishing times (the last minus the
    first), and the median over CTAs and rounds of the time from the last
    publication to a CTA seeing it, in microseconds, and the timer's
    smallest step."""
    pub, seen = stamps[0].astype(np.float64), stamps[1].astype(np.float64)
    skew = np.median(pub.max(axis=0) - pub.min(axis=0)) / 1e3
    late = np.median(seen - pub.max(axis=0)[None, :]) / 1e3
    steps = np.diff(np.unique(pub))
    return skew, late, (steps[steps > 0].min() if (steps > 0).any() else 0) / 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ctas", default="32,64,96,128",
                        help="CTA counts a matrix (comma-separated)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_grid needs a CUDA device")
    print(card())
    lib = cuda_build.variant_library("jacobi_eig_grid.cu", "-DJACOBI_GRID_PROFILE")
    device = torch.device("cuda")
    print("case | CTAs | us a round: " + ", ".join(PARTS) + " | replay lag ms, launch ms "
          "(profiled) | us, by the global timer: the CTAs' publishing spread, the last "
          "publication to a CTA seeing it, the timer's step | the shipped kernel's "
          "device_ms | same bits as it")
    for k, B in SHAPES:
        for warm in (True, False):
            X, _, V_prev = eig_case(B, k, warm, seed=k * B + warm)
            X = torch.as_tensor(X, device=device)
            V_prev = torch.as_tensor(np.ascontiguousarray(V_prev), device=device)
            W, V0, stale = E.amortized_rotate(X, V_prev)
            W, V0 = W.contiguous(), V0.contiguous()
            for ctas in (int(c) for c in args.ctas.split(",")):
                if JE.grid_smem_bytes(k, ctas, 8) > JE.SMEM_MAX or ctas > k // 2:
                    continue
                P, V, parts, lag_ms, total_ms, stamp = profiled(lib, W, V0, stale, ctas)

                def shipped():
                    return JE.jacobi_eig_grid_cuda(W, V0, stale, 2, 8, ctas=ctas)

                ref = shipped()
                same = torch.equal(P, ref[0]) and torch.equal(V, ref[1])
                print(f"[{B}, {k}] float64 {'warm' if warm else 'stale'} | {ctas} | "
                      + ", ".join(f"{parts[n]:.3f}" for n in PARTS)
                      + f" | {lag_ms:.3f}, {total_ms:.3f} | "
                      + ", ".join(f"{x:.3f}" for x in stamp)
                      + f" | {device_ms(shipped, 3):.4f} | {same}", flush=True)


if __name__ == "__main__":
    main()
