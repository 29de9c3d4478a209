"""Where the time of a port slice's solve goes on a CUDA card.

    python -m cosmo_tpu_torch.profile_slice [--problem block_sdp|banded]
        [--dtype float32|float64] [--out DIR]

``--problem block_sdp`` (the first slice): ``problems.block_sdp(512, 16,
512, seed=0)`` with CSR A, plain ADMM, no decomposition. ``--problem
banded`` (the second slice): ``problems.banded_sdp(10000, 8, seed=0,
sparse=True)`` through chordal decomposition and the block-diagonal KKT,
plain ADMM, float64 only (float32 there needs the df32 endgame, not ported);
set ``COSMO_TPU_PALLAS_RR=1`` to profile the slot-rotation kernel.

The problem is solved once to warm up, once more without the profiler and
once under ``torch.profiler``. It prints the set-up and loop times of the
unprofiled solve, the Jacobi kernel's share of its loop, the device-busy
share of the profiled loop, and the device time by kernel (device events
only: kernels and copies). With ``--out DIR`` the table is also written to
``DIR/profile_slice_<problem>_<dtype>.json``. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--problem", choices=("block_sdp", "banded"), default="block_sdp")
    parser.add_argument("--dtype", choices=("float32", "float64"), default=None,
                        help="default: float32 for block_sdp, float64 for banded")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--out", help="directory for profile_slice_<problem>_<dtype>.json")
    args = parser.parse_args(argv)

    import numpy as np
    import scipy.sparse as sp
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    if args.problem == "block_sdp":
        dtype = args.dtype or "float32"
        P, q, A, b, sets = problems.block_sdp(n_blocks=512, side=16, n=512, seed=0)
        data, label = (P, q, sp.csr_matrix(A), b, sets), "block_sdp(512,16,512)"
        settings = pt.Settings(accelerator=None, decompose=False, eps_abs=1e-5,
                               eps_rel=1e-5, dtype=getattr(np, dtype))
    else:
        dtype = args.dtype or "float64"
        data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
        label = "banded_sdp(10000,8) decomposed"
        settings = pt.Settings(decompose=True, accelerator=None, eps_abs=1e-5,
                               eps_rel=1e-5, max_iter=20000, dtype=getattr(np, dtype))
    model = pt.Model(settings).set(*data)
    model.optimize()                                   # warm-up
    plain = model.optimize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = model.optimize()

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:    # host-side op records
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append(dict(name=ev.key, calls=ev.count, device_ms=dev_us / 1e3))
    rows.sort(key=lambda r: -r["device_ms"])
    # the set-up's host-to-device copies run before the loop starts
    h2d = sum(r["device_ms"] for r in rows if r["name"].startswith("Memcpy HtoD")) / 1e3
    busy = sum(r["device_ms"] for r in rows) / 1e3 - h2d
    jac = sum(r["device_ms"] for r in rows if "jacobi_proj" in r["name"]) / 1e3
    loop, plain_loop = res.times.iter_time, plain.times.iter_time
    kernel = model.last_solve["jacobi_kernel"]
    card = _card()
    print(f"{card}; {label} {dtype}: {res.status}, {res.iter} iters, KKT "
          f"{model.last_solve['kkt_solver']}, kernel {kernel}")
    print(f"unprofiled: graph {plain.times.graph_time:.4f} s, set-up "
          f"{plain.times.setup_time:.4f} s, loop {plain_loop:.4f} s "
          f"({plain.iter / plain_loop:.1f} iter/s), {kernel} {100 * jac / plain_loop:.1f}% "
          f"of the loop")
    print(f"profiled: set-up {res.times.setup_time:.4f} s, loop {loop:.4f} s, device busy "
          f"in the loop {busy:.4f} s ({100 * busy / loop:.1f}% of it), {kernel} "
          f"{jac:.4f} s, set-up copies {h2d:.4f} s")
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for r in rows[: args.top]:
        print(f"{r['device_ms']:10.3f} {r['calls']:6d}  {r['name'][:100]}")
    if not args.out:
        return
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_slice_{args.problem}_{dtype}.json"),
              "w") as f:
        json.dump(dict(card=card, problem=args.problem, dtype=dtype,
                       kernel=kernel,
                       status=res.status, iter=res.iter,
                       setup_s=plain.times.setup_time, loop_s=plain_loop,
                       profiled_loop_s=loop, device_busy_loop_s=busy, setup_h2d_s=h2d,
                       jacobi_s=jac, kernels=rows), f, indent=1)


if __name__ == "__main__":
    main()
