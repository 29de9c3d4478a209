"""How often the last assertion of ``examples.portfolio_backtest`` holds:
the fastest re-solve must beat the first solve on the host clock. In the
JAX package the first solve compiles; here it builds the device problem
and, on a CUDA device, captures the scaling as a CUDA graph that the
re-solves replay (``ops/scaling.RuizGraph``); on the CPU it only builds
the device problem, so the margin there is small and the assertion can
fail on noise.

    python -m cosmo_tpu_torch.backtest_margins [--runs 20] [--device cuda]

Runs the example's re-solve loop ``--runs`` times in this process (the
first run also pays the process's first solve) and prints, for each run,
the first solve's and the fastest re-solve's milliseconds and whether the
assertion held, then one JSON line with every run's margin and every
period's milliseconds.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json

import torch

from .examples.portfolio_backtest import backtest


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    runs = []
    for r in range(args.runs):
        with contextlib.redirect_stdout(io.StringIO()):
            times = backtest(args.device)
        first, best = 1e3 * times[0], 1e3 * min(times[1:])
        runs.append(dict(first_ms=first, best_resolve_ms=best, margin_ms=first - best,
                         held=best < first, times_ms=[1e3 * t for t in times]))
        print(f"run {r}: first {first:.3f} ms, fastest re-solve {best:.3f} ms, "
              f"margin {first - best:.3f} ms, {'held' if best < first else 'FAILED'}")
    held = sum(r["held"] for r in runs)
    print(json.dumps(dict(device=args.device, runs=runs, held=held, of=len(runs))))
    return 0 if held == len(runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
