"""Where the time of a CG KKT solve goes on a CUDA card.

    python -m cosmo_tpu_torch.profile_cg [--problem portfolio|banded|maxcut]
        [--nodes N] [--dtype float32|float64] [--blocks 1,2,4,8]
        [--steps S] [--top T] [--out DIR]

The problem's reduced KKT system as the solver first sees it: the
Ruiz-scaled P and A (``Coo``), rho from the row classes at the initial
rho, the overlap preconditioner of a compact decomposition where the model
builds one, random right-hand sides from a fixed seed. ``--problem
portfolio --nodes K``: the portfolio QP at K factors (default 200; 100 K
assets) at default settings; ``--problem banded --nodes N``: the
decomposed ``banded_sdp(N, 8)`` (default 10000) at the north-star settings
with ``kkt_solver="cg"``; ``--problem maxcut --nodes N``: the decomposed
``maxcut(N, 4/N)`` (default 10000) likewise. First, on the device's P and
A, the ms of one product of each kind (``A x``, ``A'y``, ``P x``) summed
by ``torch.segment_reduce`` and by ``index_add_`` on the same inputs, and
which of the two ``linops._coo_segment_sum`` takes. Each CG solve runs exactly S steps (default 250;
the target is the finite-precision floor, which S steps do not reach),
plain and, with ``--dtype float32``, with the compensated restart of the
refined endgame: for each block size (steps between host reads), eager
and as the solver runs it on the card (each block one replay of a CUDA
graph, ``kkt.CGGraph``), its host ms a step and host reads, in turns and
then in reverse; then one plain eager
solve at ``CG_BLOCK`` under ``torch.profiler`` for the device operations
and device ms a step and the top device kernels. With ``--out DIR`` the
table is also written to ``DIR/profile_cg_<problem>_<dtype>.json``. Needs
CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from .profile_slice import NORTHSTAR, _card, _print_rows, device_rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--problem", choices=("portfolio", "banded", "maxcut"),
                        default="portfolio")
    parser.add_argument("--nodes", type=int, default=None,
                        help="the portfolio's factors (200), the SDP's nodes (10000)")
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    parser.add_argument("--blocks", default="1,2,4,8")
    parser.add_argument("--steps", type=int, default=250)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--out", help="directory for the json table")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cosmo_tpu_torch as pt
    from . import problems, solver
    from .models.model import refine_hint
    from .ops import kkt as kkt_ops
    from .ops import scaling as scaling_ops
    from .settings import split_settings

    if not torch.cuda.is_available():
        raise SystemExit("profile_cg needs a CUDA device")
    device = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    if args.problem == "portfolio":
        size = args.nodes or 200
        data = problems.portfolio(size, 1.0, seed=0)
        settings = pt.Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=getattr(np, args.dtype))
    else:
        size = args.nodes or 10000
        data = (problems.banded_sdp(size, 8, seed=0, sparse=True)[:5]
                if args.problem == "banded"
                else problems.maxcut(size, 4.0 / size, seed=0, sparse=True)[:5])
        settings = pt.Settings(**NORTHSTAR, kkt_solver="cg", dtype=getattr(np, args.dtype))
    # a two-iteration solve builds the model's device problem
    model = pt.Model(settings.replace(max_iter=2), device=device).set(*data)
    model.optimize()
    dev, info = model._dev_cache, model.last_solve
    sets = (model._chordal_info.problem[4] if model._chordal_info is not None
            else model.sets)
    m, n = dev["bd"].shape[0], dev["qd"].shape[0]
    static, dyn = split_settings(model._resolved_settings, m, n, dtype,
                                 refine_hint=refine_hint(sets, model._chordal_info),
                                 device=device)
    with solver._full_f32_matmuls():
        P, A, q, b, lb, ub, sm = scaling_ops.ruiz_scale(
            dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], dev["cones"],
            static.scaling_iters, dyn)
        cones = dataclasses.replace(dev["cones"], lb=lb, ub=ub)
        rho_vec = solver._make_rho_vec(dyn.rho, solver._classify_rows(cones, b, lb, ub, dyn),
                                       dyn, dev["rho_row_scale"])
        gen = torch.Generator().manual_seed(0)
        r1 = torch.randn(n, generator=gen, dtype=torch.float64).to(device, dtype)
        r2 = torch.randn(m, generator=gen, dtype=torch.float64).to(device, dtype)
        x0 = torch.zeros(n, dtype=dtype, device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        precond = dev["kkt_precond"]

        graph = kkt_ops.CGGraph()

        def cg(block, refine, graphed=False):
            return kkt_ops.cg_solve(P, A, dyn.sigma, rho_vec, r1, r2, x0, zero, zero,
                                    args.steps, refine, precond=precond, block=block,
                                    graph=graph if graphed else None)

        card = _card()
        label = (f"{args.problem}({size}) {args.dtype}: m {m}, n {n}, A nnz "
                 f"{A.vals.numel()}, P nnz {P.vals.numel()}, preconditioner "
                 f"{'overlap' if precond is not None else 'Jacobi'}, "
                 f"KKT {info['kkt_solver']}")
        print(f"{card}; {label}")
        table = dict(card=card, problem=args.problem, size=size, dtype=args.dtype, m=m, n=n,
                     nnz_A=A.vals.numel(), nnz_P=P.vals.numel(),
                     precond="overlap" if precond is not None else "jacobi", steps=args.steps,
                     segment_sums=segment_sums(P, A, card), blocks=[])
        refines = (0, 1) if args.dtype == "float32" else (0,)
        sizes = [int(v) for v in args.blocks.split(",")]
        for refine in refines:
            x_ref = cg(sizes[0], refine)[0]            # warm-up
            for block in sizes + sizes[::-1]:
                for graphed in (False, True):
                    cg(block, refine, graphed)         # a capture, once a block
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    x, _, k, reads = cg(block, refine, graphed)
                    steps = int(k)                     # ends in a host read
                    wall = time.perf_counter() - t0
                    diff = (x - x_ref).abs().max().item()
                    row = dict(refine=refine, block=block, graph=graphed, steps=steps,
                               reads=reads, wall_s=wall,
                               ms_per_step=1e3 * wall / max(steps, 1), max_abs_diff=diff)
                    table["blocks"].append(row)
                    print(f"refine {refine} block {block} {'graph' if graphed else 'eager'}: "
                          f"{steps} steps, {reads} host reads, {wall:.4f} s, "
                          f"{row['ms_per_step']:.4f} ms a step, |x - x_eager| {diff:.2e} "
                          f"[{card}]")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, k, reads = cg(None, 0)
            steps = int(k)
            wall = time.perf_counter() - t0
        rows = device_rows(prof)
        copies = sum(r["calls"] for r in rows if r["name"].startswith(("Memcpy", "Memset")))
        kernels = sum(r["calls"] for r in rows) - copies
        busy = sum(r["device_ms"] for r in rows)
        table["profiled"] = dict(block=kkt_ops.CG_BLOCK, steps=steps, reads=reads,
                                 wall_s=wall, kernels_per_step=kernels / steps,
                                 copies_per_step=copies / steps,
                                 device_ms_per_step=busy / steps,
                                 busy_share=busy / 1e3 / wall, top=rows[: args.top])
        print(f"profiled, block {kkt_ops.CG_BLOCK}: {steps} steps in {wall:.4f} s, "
              f"{kernels / steps:.1f} kernels and {copies / steps:.1f} copies or sets a "
              f"step, device busy {busy / steps:.4f} ms a step "
              f"({100 * busy / 1e3 / wall:.1f}% of the profiled wall)")
        _print_rows(rows[: args.top])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_cg_{args.problem}_{args.dtype}.json"),
                  "w") as f:
            json.dump(table, f, indent=1)


def segment_sums(P, A, card, reps=50):
    """ms (``launch_ms``, the median of ``reps``) of one product of each
    kind, ``A x``, ``A'y`` and ``P x``, its segments summed by
    ``torch.segment_reduce`` over the pointers and by ``index_add_`` over
    the sorted ids, on the same inputs; with the largest difference of the
    two and the one that ``linops._coo_segment_sum`` takes."""
    import torch

    from .kernel_timing import launch_ms
    from .ops import linops

    gen = torch.Generator().manual_seed(1)
    rows = []
    for name, M, transpose in (("A x", A, False), ("A'y", A, True), ("P x", P, False)):
        v = torch.randn(M.m if transpose else M.n, generator=gen, dtype=torch.float64)
        v = v.to(M.vals.device, M.vals.dtype)
        if transpose:
            prod = lambda: M.cvals * v[M.crows]  # noqa: E731
            ids, ptr, num, widest = M.ccols, M.col_ptr, M.n, M.max_col_nnz
        else:
            prod = lambda: M.vals * v[M.cols]  # noqa: E731
            ids, ptr, num, widest = M.rows, M.row_ptr, M.m, M.max_row_nnz
        reduce = lambda: torch.segment_reduce(prod(), "sum", offsets=ptr,  # noqa: E731
                                               unsafe=True)
        add = lambda: linops._segment_sum(prod(), ids, num)  # noqa: E731
        row = dict(product=name, nnz=M.vals.numel(), segments=num, widest=widest,
                   segment_reduce_ms=launch_ms(reduce, reps), index_add_ms=launch_ms(add, reps),
                   max_abs_diff=(reduce() - add()).abs().max().item(),
                   port_takes=("segment_reduce" if widest >= linops.SEGMENT_REDUCE_WIDTH
                               else "index_add_"))
        rows.append(row)
        print(f"{name}: {row['nnz']} entries in {num} segments (widest {widest}): "
              f"segment_reduce {row['segment_reduce_ms']:.4f} ms, index_add_ "
              f"{row['index_add_ms']:.4f} ms, max |diff| {row['max_abs_diff']:.2e}; the port "
              f"takes {row['port_takes']} [{card}]")
    return rows


if __name__ == "__main__":
    main()
