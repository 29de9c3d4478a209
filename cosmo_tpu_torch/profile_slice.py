"""Where the time of a port slice's solve goes on a CUDA card.

    python -m cosmo_tpu_torch.profile_slice [--problem block_sdp|banded|maxcut]
        [--nodes N] [--settings plain|default] [--dtype float32|float64]
        [--out DIR]

``--problem block_sdp`` (the first slice): ``problems.block_sdp(512, 16,
512, seed=0)`` with CSR A, plain ADMM, no decomposition. ``--problem
banded`` (the second slice): ``problems.banded_sdp(10000, 8, seed=0,
sparse=True)`` through chordal decomposition and the block-diagonal KKT,
with plain ADMM in float64 by default. ``--settings default`` (the fourth
slice, banded only) solves it at the north-star settings of ``bench.py``
(eps 1e-5, max_iter 20000, every other option at its default: Anderson
acceleration, the refine latch, the df32 block KKT), float32 by default.
``--problem maxcut --nodes N`` (the fifth slice): ``problems.maxcut(N,
4/N, seed=0, sparse=True)`` at the settings of ``bench.py``'s
``_bench_maxcut10k`` for N = 10000 (eps 1e-5, max_iter 20000, a 600 s
time limit, float32) and ``_bench_maxcut_default`` otherwise (the same
without the limit), which are default settings; it adds each PSD bucket's
gather, projection and scatter times (:func:`bucket_times`). Set
``COSMO_TPU_PALLAS_RR=1`` to profile the slot-rotation kernel.

The problem is solved once to warm up, once more without the profiler
(set-up and loop times) and once under ``torch.profiler``: the whole solve
with plain settings (the Jacobi kernel's share of the loop, the
device-busy share of the profiled loop, the device time by kernel: device
events only, kernels and copies); with ``--settings default`` 100 plain
and 100 refined iterations (:class:`IterationWindows`), each window with
its device operations an iteration, busy share, Jacobi share and device
time by kernel, and the solver's host waits split at the refine latch.
With ``--out DIR`` the table is also written to
``DIR/profile_slice_<problem>_<settings>_<dtype>.json`` (the problem's
name with its node count for maxcut). Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

# bench.py _bench_northstar without its time limit, and _bench_maxcut_default
# (_bench_maxcut10k adds time_limit=600)
NORTHSTAR = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000, decompose=True)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def device_rows(prof):
    """Device events of a profile by name: [{name, calls, device_ms}], the
    largest first (kernels and copies; host-side op records left out)."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        rows.append(dict(name=ev.key, calls=ev.count, device_ms=dev_us / 1e3))
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


class IterationWindows:
    """A solver ``on_iter`` hook: profiles ``width`` plain iterations from
    ``plain_at`` on (when the refine latch is still off there) and the
    ``width`` iterations after the latch trips, each window timed on the
    host clock. ``caught``, a list that ``warnings.catch_warnings(record=
    True)`` fills, is read at the latch, so the synchronizing calls
    ``torch.cuda.set_sync_debug_mode("warn")`` flags can be split there."""

    def __init__(self, caught=(), plain_at=100, width=20):
        self.caught, self.plain_at, self.width = caught, plain_at, width
        self.prof = {}
        self.open = None
        self.warned_at_latch = None

    def _stop(self):
        phase, _ = self.open
        prof, start, t0 = self.prof[phase]
        wall = time.perf_counter() - t0
        prof.stop()
        self.prof[phase] = (prof, start, wall)
        self.open = None

    def __call__(self, it, refine_on):
        from torch.profiler import ProfilerActivity, profile

        if self.open is not None and it >= self.open[1]:
            self._stop()
        if refine_on and self.warned_at_latch is None:
            self.warned_at_latch = len(self.caught)
        phase = ("refined" if refine_on else
                 "plain" if it == self.plain_at else None)
        if self.open is None and phase is not None and phase not in self.prof:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            self.prof[phase] = (prof, it, time.perf_counter())
            self.open = (phase, it + self.width)

    def close(self, last_it, top=0):
        """Each window's iterations, host seconds (profiler on), device
        operations an iteration (kernels; copies and sets), device busy
        seconds and share of the window, the Jacobi kernels' device
        seconds, and its ``top`` device events by time."""
        if self.open is not None:
            self._stop()
        out = {}
        for phase, (prof, start, wall) in self.prof.items():
            iters = max(min(start + self.width, last_it) - start, 1)
            rows = device_rows(prof)
            copies = sum(r["calls"] for r in rows
                         if r["name"].startswith(("Memcpy", "Memset")))
            kernels = sum(r["calls"] for r in rows) - copies
            busy = sum(r["device_ms"] for r in rows) / 1e3
            out[phase] = dict(
                iters=iters, wall_s=wall, kernels_per_iter=kernels / iters,
                copies_per_iter=copies / iters, device_busy_s=busy,
                busy_share=busy / wall,
                jacobi_s=sum(r["device_ms"] for r in rows if "jacobi_proj" in r["name"]) / 1e3,
                top=rows[:top])
        return out


def bucket_times(model, reps=20):
    """Each PSD bucket of ``model``'s last solve, as (B, side, layout,
    backend), with the ``launch_ms`` of its gather, projection and scatter
    on a random input of the solve's shape and type (no solve state is
    touched)."""
    import torch

    from .kernel_timing import launch_ms
    from .ops import projections as pr
    from .solver import _full_f32_matmuls

    cones = model._dev_cache["cones"]
    w = torch.randn(cones.m, dtype=model.last_solve["dtype"], device=cones.lb.device)
    v_ext = pr._ext(w)
    out = []
    with _full_f32_matmuls():        # as in the solve
        for b in cones.psd_buckets:
            X = pr._psd_gather(v_ext, b)
            Y = pr._psd_project_bucket(X, cones, b)
            s = w.clone()
            out.append(dict(
                B=b.batch, side=b.side, layout=b.fastpath,
                backend=b.backend or cones.eigh_backend,
                gather_ms=launch_ms(lambda: pr._psd_gather(v_ext, b), reps),
                project_ms=launch_ms(lambda: pr._psd_project_bucket(X, cones, b), reps),
                scatter_ms=launch_ms(lambda: pr._psd_scatter(s, Y, b), reps)))
    return out


def host_waits(last_solve, iters):
    """The solver's host waits an iteration before and after the refine
    latch (``Model.last_solve``; all plain when it never tripped)."""
    latch = last_solve["refine_iter"]
    if latch <= 0:
        return dict(plain=last_solve["syncs"] / max(iters, 1), refined=None)
    return dict(plain=last_solve["refine_syncs"] / latch,
                refined=(last_solve["syncs"] - last_solve["refine_syncs"])
                / max(iters - latch, 1))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--problem", choices=("block_sdp", "banded", "maxcut"),
                        default="block_sdp")
    parser.add_argument("--nodes", type=int, default=10000, help="maxcut's node count")
    parser.add_argument("--settings", choices=("plain", "default"), default="plain")
    parser.add_argument("--dtype", choices=("float32", "float64"), default=None,
                        help="default: float32 for block_sdp and --settings default, "
                             "float64 for plain banded")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--out", help="directory for the json table")
    args = parser.parse_args(argv)

    import numpy as np
    import scipy.sparse as sp
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    if args.problem == "maxcut":
        args.settings = "default"
    elif args.settings == "default" and args.problem != "banded":
        raise SystemExit("--settings default profiles the banded problem")
    name = args.problem
    if args.problem == "maxcut":
        dtype = args.dtype or "float32"
        name = f"maxcut{args.nodes}"
        data = problems.maxcut(args.nodes, 4.0 / args.nodes, seed=0, sparse=True)[:5]
        label = f"maxcut({args.nodes}) decomposed, bench.py settings"
        settings = pt.Settings(**NORTHSTAR, dtype=getattr(np, dtype),
                               time_limit=600.0 if args.nodes == 10000 else 0.0)
    elif args.problem == "block_sdp":
        dtype = args.dtype or "float32"
        P, q, A, b, sets = problems.block_sdp(n_blocks=512, side=16, n=512, seed=0)
        data, label = (P, q, sp.csr_matrix(A), b, sets), "block_sdp(512,16,512)"
        settings = pt.Settings(accelerator=None, decompose=False, eps_abs=1e-5,
                               eps_rel=1e-5, dtype=getattr(np, dtype))
    else:
        data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
        label = f"banded_sdp(10000,8) decomposed, {args.settings} settings"
        if args.settings == "default":
            dtype = args.dtype or "float32"
            settings = pt.Settings(**NORTHSTAR, dtype=getattr(np, dtype))
        else:
            dtype = args.dtype or "float64"
            settings = pt.Settings(**NORTHSTAR, accelerator=None,
                                   dtype=getattr(np, dtype))
    model = pt.Model(settings).set(*data)
    model.optimize()                                   # warm-up
    plain = model.optimize()
    info = dict(model.last_solve)
    kernel, plain_loop = info["jacobi_kernel"], plain.times.iter_time
    card = _card()
    print(f"{card}; {label} {dtype}: {plain.status}, {plain.iter} iters, KKT "
          f"{info['kkt_solver']}, kernel {kernel}")
    print(f"unprofiled: graph {plain.times.graph_time:.4f} s, set-up "
          f"{plain.times.setup_time:.4f} s, loop {plain_loop:.4f} s "
          f"({plain.iter / plain_loop:.1f} iter/s)")
    table = dict(card=card, problem=name, settings=args.settings, dtype=dtype,
                 kernel=kernel, status=plain.status, iter=plain.iter,
                 graph_s=plain.times.graph_time, setup_s=plain.times.setup_time,
                 loop_s=plain_loop)
    if args.problem == "maxcut":
        table["buckets"] = bucket_times(model)
        print(f"{'B':>6} {'side':>5} {'layout':>7} {'backend':>7} {'gather ms':>10} "
              f"{'project ms':>11} {'scatter ms':>11}")
        for r in table["buckets"]:
            print(f"{r['B']:6d} {r['side']:5d} {r['layout']:>7} {r['backend']:>7} "
                  f"{r['gather_ms']:10.4f} {r['project_ms']:11.4f} {r['scatter_ms']:11.4f}")
    if args.settings == "default":
        # a whole profiled solve of ~2,000 iterations at ~650 device
        # operations each is too long to trace: profile windows instead
        waits = host_waits(info, plain.iter)
        windows = IterationWindows(width=100)
        res = model.optimize(on_iter=windows)
        per = windows.close(res.iter, top=args.top)
        print(f"{plain.safeguarding_iter} safeguarding iterations, "
              f"{info['n_accelerated']} accelerated, refine latch at iteration "
              f"{info['refine_iter']}; host waits an iteration {waits}")
        for phase, w in per.items():
            print(f"{phase} window (profiled solve, from iteration "
                  f"{windows.prof[phase][1]}): {w['iters']} iters in {w['wall_s']:.4f} s, "
                  f"{w['kernels_per_iter']:.1f} kernels and {w['copies_per_iter']:.1f} "
                  f"copies or sets an iteration, device busy {w['device_busy_s']:.4f} s "
                  f"({100 * w['busy_share']:.1f}%), {kernel} {w['jacobi_s']:.4f} s "
                  f"({100 * w['jacobi_s'] / w['wall_s']:.1f}%)")
            _print_rows(w["top"])
        table.update(n_accelerated=info["n_accelerated"],
                     safeguarding_iter=plain.safeguarding_iter,
                     refine_iter=info["refine_iter"], host_waits_per_iter=waits,
                     windows=per)
    else:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = model.optimize()
        rows = device_rows(prof)
        # the set-up's host-to-device copies run before the loop starts
        h2d = sum(r["device_ms"] for r in rows
                  if r["name"].startswith("Memcpy HtoD")) / 1e3
        busy = sum(r["device_ms"] for r in rows) / 1e3 - h2d
        jac = sum(r["device_ms"] for r in rows if "jacobi_proj" in r["name"]) / 1e3
        loop = res.times.iter_time
        print(f"{kernel} {100 * jac / plain_loop:.1f}% of the unprofiled loop; "
              f"profiled: set-up {res.times.setup_time:.4f} s, loop {loop:.4f} s, "
              f"device busy in the loop {busy:.4f} s ({100 * busy / loop:.1f}% of it), "
              f"{kernel} {jac:.4f} s, set-up copies {h2d:.4f} s")
        _print_rows(rows[: args.top])
        table.update(profiled_loop_s=loop, device_busy_loop_s=busy, setup_h2d_s=h2d,
                     jacobi_s=jac, kernels=rows)
    if not args.out:
        return
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_slice_{name}_{args.settings}_"
                                     f"{dtype}.json"), "w") as f:
        json.dump(table, f, indent=1)


def _print_rows(rows):
    print(f"{'device ms':>10} {'calls':>6}  kernel")
    for r in rows:
        print(f"{r['device_ms']:10.3f} {r['calls']:6d}  {r['name'][:100]}")


if __name__ == "__main__":
    main()
