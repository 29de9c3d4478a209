#!/usr/bin/env python3
"""Smoke run of cosmo_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out DIR] [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: compiles both kernels' libraries with nvcc for sm_90a, one nvcc
   per source, all started together: the Jacobi kernels' from
   ``cosmo_tpu_torch/csrc/jacobi_proj.cu``, ``jacobi_proj_rr.cu``,
   ``jacobi_eig.cu`` and ``jacobi_smem.cu``, the exp/pow cone projection's from
   ``exp_pow_proj.cu``; prints the ptxas reports and fails if any Jacobi
   register body instantiation (``jacobi_proj_regs``) has a stack frame
   or spills, or an exp/pow instantiation spills;
3. kernel: holds the round-robin and the slot-rotation Jacobi projection
   kernels against their plain PyTorch versions on the card (float32 and
   float64, k in {4, 6, ..., 16, 24, 32, 48}, B in {1, 512, 2498, 8540},
   and the maxcut path's k = 8 at B in {1729, 8540}); at the kernels
   line's shapes ([2498, 16] and [8540, 8]) it times kernel, plain version
   and ``torch.linalg.eigh`` yardstick with CUDA events; then the exp/pow
   kernel against its plain version (float32 and float64, primal and dual
   rows of all four cases, pow at alpha 0.3, 0.5, 0.8, N in {1, 1000,
   65122}), timed and bounded at N = 65,122;
4. slice: solves ``problems.block_sdp(512, 16, 512, seed=0)`` with CSR A
   through ``Model.optimize`` on the card with plain ADMM, in float64 and
   float32 (a first solve, then a second on the same model), against the
   known objective, and checks that every projection of each solve went
   through the kernel; then the four known answers in float64, and (the
   "plugins" timer) the QP through the one-call ``solve`` with a cone
   dict, a ``CustomCone``, a ``CustomKKTSolver`` whose solve calls
   ``torch.linalg.solve``, and the power cone's known answer through the
   pow kernel;
5. decomposed: solves ``problems.banded_sdp(10000, 8, seed=0, sparse=True)``
   through chordal decomposition and the block-diagonal KKT in float64,
   once with the default (round-robin) kernel and once with the
   slot-rotation kernel of ``COSMO_TPU_PALLAS_RR=1`` (each a first
   solve, then a second on the same model), against the
   known objective, and checks that every projection of each solve went
   through the kernel that run selects and none through the other;
6. default: solves the same decomposed problem at the north-star settings
   of ``bench.py`` (``Settings(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000,
   decompose=True)``, every other option at its default: Anderson
   acceleration, the f32 refine latch and the df32-compensated block KKT)
   in float32 (the card's default; the float64 solve is left out for the
   run's time), against the known objective; checks the block KKT, that
   every projection went through ``jacobi_proj``, that the refine latch
   tripped and Anderson accelerated. A second solve on the same model
   profiles 20 plain and 20 refined iterations (``torch.profiler``) for
   the device operations an iteration, under
   ``torch.cuda.set_sync_debug_mode("warn")``;
7. maxcut: the decomposed maxcut SDP of ``bench.py``, float32, one first
   solve of ``problems.maxcut(10000, 4/10000, seed=0, sparse=True)`` at
   ``_bench_maxcut10k``'s settings (with its 600 s time limit; the
   maxcut-2000 solve is left out for the run's time), held to
   lambda_min(diag(x) - L/4) >= -1e-3 (dense, float64, on the card). Checks
   that the Jacobi kernel took exactly the dominant side-8 bucket, every
   projection of it, the polar every other bucket, and that the shear (and
   at 10k the colpad) layout is on the path; the 10k solve profiles 20
   plain and 20 refined iterations for the device operations an iteration;
8. cg and re-solves: (a) the decomposed banded SDP of phase 6 with
   ``kkt_solver="cg"``, float32: ``Coo``, the overlap preconditioner, CG
   with the df32 restarts after the refine latch, ``jacobi_proj`` on every
   projection, against the known objective; (b) the portfolio QP of the
   OSQP benchmarks at k = 200 factors (n = 20,000 assets, ~2M non-zeros,
   made from ``--seed``), default settings in float64 (``PORTFOLIO``),
   through the auto CG route: a cold solve at gamma = 1, then ``update(q)``
   and a warm start for gamma = 2, each Solved, held to float64 host checks
   of x, y and s against the solver's stopping rule, the duality gap
   within ``PORTFOLIO_GAP_TOL`` and the objective within twice that gap of
   the optimum of ``problems.portfolio_optimum`` (the gamma = 1 objective
   is also reported against the JAX package's ``REF_PORTFOLIO``); (c) the
   gamma = 1 problem's first 100 iterations through
   ``solver.solve_chunked`` in chunks of 50 against the same iterations
   in one call (the same status and iterations, objective within 1e-5;
   the whole solve in chunks is left out for the run's time); (d) the
   re-solve with ``verbose_timing``, its phase
   timers finite, positive where the solve ran the phase;
9. cones: (a) the a9a-shaped logistic regression (65,122 exponential
   cones, float64, defaults, eps 1e-5) against ``logistic_optimum``, the
   exp kernel on every projection; (b) ``block_sdp(8, 256, 256)`` with
   mixed precision in float32 against ``REF_BLOCK8X256``, its loose phase
   ending, and the loose phase's iter/s against full float32 at fixed
   work; (c) 2,048 3-qubit state estimates through the complex PSD cone
   in float64 and float32 against their closed form, the [2048, 16]
   bucket through ``jacobi_proj``;
10. backends and examples: (a) the warm-started Jacobi kernel of the
   amortized backend (``csrc/jacobi_eig.cu``) against its plain version
   (float32 and float64, every even k in 4..48 at B in {1, 1000, 2498}
   and [8540, 8], a warm and a stale case each), timed and bounded at
   [2498, 16] and [8540, 8] at 2 and 8 sweeps; (b) the decomposed banded
   SDP of phase 5 with ``eigh_backend="amortized"`` against the known
   objective, one kernel launch a projection, the share of full-sweep
   launches read once from the kernel's device tally, and a second solve
   under ``torch.cuda.set_sync_debug_mode("warn")`` showing that the
   projection adds no host read; (c) ``block_sdp(512, 16, 512)`` with
   ``eigh_backend="jacobi_mm"`` against the known objective; (d) every
   example of ``cosmo_tpu_torch/examples`` through its ``main("cuda")``;
11. mesh: ``Model.optimize(mesh=parallel.make_mesh())`` on ranks it spawns
   (gloo on the loopback, each process group with a 300 s time limit), after
   the unsharded references: (a) maxcut-10k at ``_bench_maxcut10k``'s
   settings with plain ADMM for 100 iterations on 2 gloo ranks that share
   the card, x and s within rtol 2e-4, atol 1e-5 of the unsharded run,
   each rank's [4270, 8] share of the side-8 bucket through ``jacobi_proj``
   on every projection (the launch counters) and the [1, 896] colpad
   bucket matrix-row sharded; (b) the banded SDP of phase 5 in float64 on
   the 2 ranks, Solved at ``REF_BANDED``, x within 1e-6 of phase 5's first
   solve, its iterations, iter/s and collectives an iteration beside phase
   5's; (c) the same problem for 200 iterations on a one-rank NCCL group,
   within 1e-9 relative of the unsharded run. Every rank's x, y and s must
   have the same bits; a rank that fails fails the run.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. With ``--out DIR`` the details also go to
``DIR/chip_smoke.json``.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REF_OBJ = -0.5062352079829      # cosmo_tpu, CPU f64, eps 1e-5 (Solved)
# cosmo_tpu on the CPU in float64: Model(Settings(decompose=True,
# accelerator=None, dtype=np.float64, eps_abs=1e-5, eps_rel=1e-5,
# max_iter=20000)).set(*problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5])
# .optimize() -> Solved, 2925 iterations, 5 rho updates
REF_BANDED = 26934.834386732622
# bench.py _bench_northstar without its time limit; dtype None: float32 on
# the card
NORTHSTAR = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000, decompose=True)
# bench.py _bench_maxcut_default and _bench_maxcut10k
MAXCUT_DEFAULT = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000, decompose=True,
                      dtype=np.float32)
MAXCUT10K = dict(MAXCUT_DEFAULT, time_limit=600.0)
# the banded-CG path of phase 8a: the north-star settings through CG
BANDED_CG = dict(NORTHSTAR, kkt_solver="cg")
# phase 8b's settings: the defaults in float64. In float32 neither package
# reaches eps 1e-5 on this problem: cosmo_tpu on the CPU,
# Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float32) on
# problems.portfolio(20) and (50) -> Max_iter_reached at 5000 iterations
# (r_prim 4.5e-5 and 2.2e-5, r_dual 1.4e-4 and 5.4e-4), and the port at
# k = 200 on the card the same
PORTFOLIO = dict(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64)
PORTFOLIO_K = 200
# the re-solve after the cold gamma = 1 (gamma = 0.5 and 4 left out for time)
PORTFOLIO_GAMMA = 2.0
# phase 8c: the chunked solve's depth and chunk
CHUNKED_ITERS, CHUNK = 100, 50
# the optimum of problems.portfolio(200, gamma, seed=0), independent of the
# ADMM solver: problems.portfolio_optimum(200, gamma) (an interior-point
# method in float64 on the host, to a complementarity gap below 1e-13)
PORTFOLIO_OPT = {1.0: -2.6232333546383533, 2.0: -1.2654503296560802}
# The duality gap of an eps 1e-5 solve is held within this share of its
# objective, and the objective within twice the gap of the optimum: the
# residual rule lets each of the 20,000 box rows sit ~1e-5 outside [0, 1],
# which moves the objective by ~1e-3 (the JAX package's own solve lands
# 2.0e-3 from the optimum; the port's gaps were 1.5e-3 to 6.5e-3 at gamma
# 1, 2 and 0.5 on the card, each objective's error within 1.2 times its gap)
PORTFOLIO_GAP_TOL = 1e-2
# cosmo_tpu on the CPU in float64: Model(Settings(eps_abs=1e-5, eps_rel=1e-5,
# dtype=np.float64)).set(*cosmo_tpu_torch.problems.portfolio(200, 1.0, seed=0))
# with cosmo_tpu's ZeroSet and Box of the same dimensions and bounds ->
# Solved through kkt_solver "cg", 952 iterations, 255,250 CG steps; reported
REF_PORTFOLIO = -2.628500495091212
# phase 9a: LIBSVM's a9a (UCI Adult) in shape: 32,561 samples, 123 binary
# features, 13.9 set a sample on average (14 here), lam = 0.5 (LIBSVM's
# C = 1 in the form 1/2 ||w||^2 + C sum loss), made from --seed
LOGISTIC = dict(n_samples=32561, n_features=123, nnz=14, lam=0.5)
LOGISTIC_SETTINGS = dict(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64)
# phase 9b: bench.py's block_sdp_8x256_mixed_loose (_bench_block_sdp's
# plain ADMM, scaling and checks; eigh_backend "polar", mixed precision),
# float32, eps 1e-5, with one df32 refinement step of the KKT solve: at
# bench.py's auto refinement (none here) neither package reaches eps 1e-5
# in float32 (on the CPU at block_sdp(8, 128, 128): both Max_iter_reached at
# 8,000 iterations, r_dual 2.7e-4; with kkt_refine_steps=1 both Solved in
# 2,625)
BLOCK8X256_MIXED = dict(accelerator=None, adaptive_rho=False, check_termination=25,
                        scaling=10, decompose=False, eigh_backend="polar",
                        mixed_precision=True, eps_abs=1e-5, eps_rel=1e-5,
                        max_iter=20000, kkt_refine_steps=1, dtype=np.float32)
# cosmo_tpu on the CPU in float64: Model(Settings(accelerator=None,
# adaptive_rho=False, check_termination=25, scaling=10, decompose=False,
# eps_abs=1e-8, eps_rel=1e-8, max_iter=100000, dtype=np.float64)).set(P, q,
# scipy.sparse.csr_matrix(A), b, sets) of problems.block_sdp(n_blocks=8,
# side=256, n=256, seed=0) -> Solved, 4425 iterations (at eps 1e-5: 2100
# iterations, -0.7128208710936345)
REF_BLOCK8X256 = -0.7128210624599856
# phase 9c: plain ADMM (the auto backend then gives the embedded [2048, 16]
# bucket the Jacobi kernel), eps 1e-5
TOMOGRAPHY = dict(accelerator=None, decompose=False, eps_abs=1e-5, eps_rel=1e-5)
# phase 5's plain settings (float64), also phase 11b's
BANDED_PLAIN = dict(decompose=True, accelerator=None, dtype=np.float64,
                    eps_abs=1e-5, eps_rel=1e-5, max_iter=20000)
# phase 11: the mesh on gloo ranks that share the card (11a, 11b) and on a
# one-rank NCCL group (11c). 11a: maxcut-10k at _bench_maxcut10k's settings
# with plain ADMM and a fixed 100 iterations, held to the unsharded run at
# the dryrun's float32 limits (__graft_entry__.py:101-110)
MESH_RANKS = 2
MAXCUT10K_MESH = dict(MAXCUT10K, accelerator=None, max_iter=100)
MESH_RTOL, MESH_ATOL = 2e-4, 1e-5
# 11c: the banded SDP for a fixed 200 iterations, within 1e-9 relative
NCCL_ITERS = 200
# the process groups' time limit: ranks that disagree fail the run
MESH_TIMEOUT_S = 300
SWEEPS = 8                      # Settings.jacobi_sweeps default
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): float32 and
# float64 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
# kernel vs plain version, relative to max |X|: f64 differs by rounding
# order only; in f32 each side carries the ~2e-5 Jacobi floor
TOL = {"float32": 1e-4, "float64": 1e-10}


def log(*args):
    print(*args, flush=True)


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    import torch

    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return smi


# the register body's instantiations: even k in 4..16, f32/f64, the two
# projection schedules and the warm-started eigendecomposition (jacobi_eig)
REGISTER_BODIES = 3 * 7 * 2


def ptxas_frames(report):
    """{kernel symbol: (stack frame, spill stores, spill loads) bytes, then
    registers} of a ``-Xptxas -v`` report."""
    frames, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frames[name] = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in frames:
            frames[name] += (int(m.group(1)),)
            name = None
    return frames


def phase_build():
    """Both kernels' libraries, one nvcc per source, all started together.
    The Jacobi register body keeps X and V in registers: an instantiation
    with a stack frame or a spill would put them in local memory, so it
    fails the build; so does a spill in the exp/pow kernel."""
    from cosmo_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    so, so_cones = cuda_build.build_all()
    seconds = time.perf_counter() - t0
    log(f"[build] {so.name} {so_cones.name}")
    report = so.with_suffix(".log").read_text()
    log(report.strip())
    cones = so_cones.with_suffix(".log").read_text()
    log(cones.strip())
    frames = {n: f for n, f in ptxas_frames(cones).items() if "_proj_kernel" in n}
    log(f"[build] exp/pow kernel instantiations (stack frame, spill stores, spill "
        f"loads, registers): {frames}")
    # the loop state stays in registers: a spill fails the build (a stack
    # frame alone may hold a math function's slow path)
    if len(frames) != 4 or any(f[1] or f[2] for f in frames.values()):
        raise AssertionError(f"{so_cones.name}: {frames}")
    regs = {n: f for n, f in ptxas_frames(report).items() if "jacobi_proj_regs" in n}
    bad = {n: f for n, f in regs.items() if any(f[:3])}
    log(f"[build] {len(regs)} register-body instantiations, {len(bad)} with a "
        f"stack frame or spills; registers {sorted(f[3] for f in regs.values())}")
    if len(regs) != REGISTER_BODIES or bad:
        raise AssertionError(f"{so.name}: register bodies {regs}")
    log(f"[build] in {seconds:.2f} s")
    return seconds


def _stack(B, k, dtype, device, seed):
    import torch

    G = np.random.default_rng(seed).standard_normal((B, k, k))
    return torch.as_tensor((G + G.swapaxes(1, 2)) / 2, dtype=dtype, device=device)


def jacobi_bound_ms(B, k, dtype_name, sweeps=SWEEPS):
    """Least time for the projection of this stack on an H100: the larger of
    its flops at the card's peak for the type (n_pairs rotations a sweep,
    each 18k + 20 flops, then the 2k^3 reconstruction) and its bytes (the
    input read once, the output written once) at the memory rate."""
    itemsize = 4 if dtype_name == "float32" else 8
    n_pairs = (k - 1) * (k // 2)
    flops = B * (sweeps * n_pairs * (18 * k + 20) + 2 * k**3)
    nbytes = 2 * B * k * k * itemsize
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _kernels():
    """name -> (uncounted launch, plain version) of each Jacobi kernel."""
    from cosmo_tpu_torch.ops import jacobi_proj as J
    from cosmo_tpu_torch.ops import jacobi_proj_rr as R

    return {"jacobi_proj": (J.jacobi_proj_cuda, J.psd_project_jacobi_plain),
            "jacobi_proj_rr": (R.jacobi_proj_rr_cuda, R.psd_project_jacobi_rr_plain)}


# the maxcut path's kernel shapes (k = 8 at maxcut-2000's and maxcut-10k's
# batch, and a rank's share of maxcut-10k's on phase 11's two ranks),
# checked beside the sweep
MAXCUT_SHAPES = ((8, 1729), (8, 8540), (8, 8540 // MESH_RANKS))
# the shapes of the kernels line (the banded paths, maxcut-10k, a rank's
# share of it), timed
TIMED_SHAPES = ((16, 2498), (8, 8540), (8, 8540 // MESH_RANKS))


def phase_kernel(device, ks=(4, 6, 8, 10, 12, 14, 16, 24, 32, 48),
                 Bs=(1, 512, 2498, 8540), dtypes=("float32", "float64"), reps=20):
    """Each kernel vs its plain version at every shape (k in ``ks`` by B in
    ``Bs``, and ``MAXCUT_SHAPES``); timings of kernel, plain version and
    eigh yardstick at ``TIMED_SHAPES`` (the yardstick once a shape, shared
    by both kernels, which also share the bound: they do the same
    rotations). ``ms``, ``plain_ms`` and ``library_ms`` are ``launch_ms``;
    ``device_ms`` is the kernel's time without the host's launch cost."""
    import torch
    from cosmo_tpu_torch.kernel_timing import device_ms, launch_ms
    from cosmo_tpu_torch.ops import eigh as E

    rows = []
    shapes = dict.fromkeys([(k, B) for k in ks for B in Bs] + list(MAXCUT_SHAPES))
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        for k, B in shapes:
            X = _stack(B, k, dtype, device, seed=1000 * k + B)
            big = B * k * k > 512 * 16 * 16 * 8
            timed = (k, B) in TIMED_SHAPES
            library_ms = (launch_ms(lambda: E.psd_project_eigh(X), 3 if big else reps)
                          if timed else None)
            bound_ms, bound_by = jacobi_bound_ms(B, k, dtype_name)
            for name, (launch, plain) in _kernels().items():
                got = launch(X, SWEEPS)
                torch.cuda.synchronize()
                ref = plain(X, SWEEPS)
                err = (got - ref).abs().max().item()
                scale = X.abs().max().item()
                ok = bool(np.isfinite(err)) and err <= TOL[dtype_name] * scale
                row = dict(
                    kernel=name, dtype=dtype_name, k=k, B=B, max_abs_err=err,
                    max_abs_x=scale, tol_rel=TOL[dtype_name], ok=ok,
                    ms=launch_ms(lambda: launch(X, SWEEPS), reps) if timed else None,
                    device_ms=(device_ms(lambda: launch(X, SWEEPS), reps)
                               if timed else None),
                    plain_ms=(launch_ms(lambda: plain(X, SWEEPS), 2 if big else 5)
                              if timed else None),
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                )
                rows.append(row)
                times = ("" if not timed else
                         f" ms={row['ms']:.4f} device={row['device_ms']:.4f} plain="
                         f"{row['plain_ms']:.3f} eigh={library_ms:.3f}")
                log(f"[kernel] {name} {dtype_name} k={k:2d} B={B:5d} err={err:.3e} "
                    f"(tol {TOL[dtype_name]:.0e}*{scale:.2f}){times} "
                    f"bound={bound_ms:.5f} ({bound_by}) {'ok' if ok else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"a kernel disagrees with its plain version: {bad}")
    return rows


def block_sdp_model(device, dtype, n_blocks=512, side=16, n=512, seed=0, **extra):
    """block_sdp with CSR A set on a Model with plain ADMM, eps 1e-5 (and the
    settings ``extra``)."""
    import scipy.sparse as sp
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    P, q, A, b, sets = problems.block_sdp(n_blocks=n_blocks, side=side, n=n, seed=seed)
    model = pt.Model(pt.Settings(accelerator=None, decompose=False, eps_abs=1e-5,
                                 eps_rel=1e-5, dtype=dtype, **extra), device=device)
    return model.set(P, q, sp.csr_matrix(A), b, sets)


def counted_optimize(model, on_iter=None):
    """model.optimize(on_iter=...) with every kernel's launch count set to
    0 just before and read just after; returns (result, {kernel:
    launches})."""
    from cosmo_tpu_torch.ops import exp_pow_proj as K
    from cosmo_tpu_torch.ops import jacobi_eig as JE
    from cosmo_tpu_torch.ops import jacobi_proj as J
    from cosmo_tpu_torch.ops import jacobi_proj_rr as R

    J.psd_project_pallas.launches = R.psd_project_rr.launches = 0
    K.project_exp.launches = K.project_pow.launches = 0
    JE.reset_counts()
    res = model.optimize(on_iter=on_iter)
    return res, {"jacobi_proj": J.psd_project_pallas.launches,
                 "jacobi_proj_rr": R.psd_project_rr.launches,
                 "exp_pow_proj/exp": K.project_exp.launches,
                 "exp_pow_proj/pow": K.project_pow.launches,
                 "jacobi_eig": sum(JE.psd_project_amortized.launches.values())}


def phase_slice(device, smi):
    """The main path at full size, f64 then f32 (the card's default). Each
    model solves twice: the first solve also pays the one-time CUDA
    library set-up, the second is the steady state; both are checked."""
    out = {}
    for dtype, rel in ((np.float64, 1e-6), (None, 1e-4)):
        name = "float64" if dtype is not None else "float32"
        model = block_sdp_model(device, dtype)
        for run in ("cold", "warm"):
            res, counts = counted_optimize(model)
            launches = counts["jacobi_proj"]
            info = model.last_solve
            err = abs(res.obj_val - REF_OBJ) / abs(REF_OBJ)
            ips = res.iter / info["iter_time"]
            log(f"[slice] block_sdp(512,16,512) {name} {run}: {res.status}, "
                f"{res.iter} iters, obj {res.obj_val:.13f} (rel err {err:.2e}, "
                f"limit {rel:.0e}), setup {res.times.setup_time:.3f} s, solve "
                f"{info['iter_time']:.3f} s, {ips:.1f} iter/s, A {info['A_layout']}, "
                f"PSD backend {info['bucket_backends']}, kernel launches {launches} / "
                f"projections {info['projections']} [{smi}]")
            if res.status != "Solved" or not err <= rel:
                raise AssertionError(f"block_sdp {name}: {res.status}, obj {res.obj_val}")
            if info["A_layout"] != "Bde" or info["bucket_backends"] != ("pallas",):
                raise AssertionError(f"block_sdp {name} left the main path: {info}")
            if not launches == info["projections"] > 0 or counts["jacobi_proj_rr"]:
                raise AssertionError(f"block_sdp {name}: {counts} kernel launches for "
                                     f"{info['projections']} projections")
            out[f"{name}_{run}"] = dict(
                status=res.status, iter=res.iter, obj=res.obj_val, rel_err=err,
                setup_s=res.times.setup_time, solve_s=info["iter_time"],
                iter_per_s=ips, launches=launches, projections=info["projections"])
    return out


def phase_decomposed(device, smi):
    """The decomposed banded SDP through the block-diagonal KKT in float64:
    one run with the default (round-robin) kernel, one with COSMO_TPU_PALLAS_RR
    set for that run only; each solves cold (a new model: decomposition,
    analysis, copies) and then warm (the same model: every cache hits).
    Returns also, as ``x``, the first solve's x: phase 11b's unsharded
    reference."""
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import native, problems

    t0 = time.perf_counter()
    data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    log(f"[decomposed] banded_sdp(10000, 8) generated in "
        f"{time.perf_counter() - t0:.2f} s")
    settings = pt.Settings(**BANDED_PLAIN)
    out = {}
    for kernel, env in (("jacobi_proj", None), ("jacobi_proj_rr", "1")):
        other = "jacobi_proj_rr" if kernel == "jacobi_proj" else "jacobi_proj"
        if env is not None:
            os.environ["COSMO_TPU_PALLAS_RR"] = env
        try:
            model = pt.Model(settings, device=device).set(*data)
            for run in ("cold", "warm"):
                res, counts = counted_optimize(model)
                info, t = model.last_solve, res.times
                err = abs(res.obj_val - REF_BANDED) / abs(REF_BANDED)
                ips = res.iter / info["iter_time"]
                log(f"[decomposed] {kernel} {run}: {res.status}, {res.iter} iters, obj "
                    f"{res.obj_val:.12f} (rel err {err:.2e}, limit 1e-06), graph "
                    f"{t.graph_time:.3f} s, setup {t.setup_time:.3f} s, solve "
                    f"{info['iter_time']:.3f} s, {ips:.1f} iter/s, post {t.post_time:.3f} s, "
                    f"KKT {info['kkt_solver']}, {info['chordal_blocks']} blocks, PSD "
                    f"backend {info['bucket_backends']}, kernel {info['jacobi_kernel']}, "
                    f"launches {counts} / projections {info['projections']}, native "
                    f"library {native.available()} [{smi}]")
                if res.status != "Solved" or not err <= 1e-6:
                    raise AssertionError(f"banded {kernel}: {res.status}, obj {res.obj_val}")
                if (info["kkt_solver"] != "blockdiag"
                        or info["bucket_backends"] != ("pallas",)
                        or info["jacobi_kernel"] != kernel):
                    raise AssertionError(f"banded {kernel} left the main path: {info}")
                if not counts[kernel] == info["projections"] > 0 or counts[other]:
                    raise AssertionError(f"banded {kernel}: {counts} kernel launches for "
                                         f"{info['projections']} projections")
                out[f"{kernel}_{run}"] = dict(
                    status=res.status, iter=res.iter, obj=res.obj_val, rel_err=err,
                    graph_s=t.graph_time, setup_s=t.setup_time, solve_s=info["iter_time"],
                    post_s=t.post_time, iter_per_s=ips, launches=counts[kernel],
                    projections=info["projections"], blocks=info["chordal_blocks"],
                    native=native.available())
                if kernel == "jacobi_proj" and run == "cold":
                    out["x"] = res.x
        finally:
            os.environ.pop("COSMO_TPU_PALLAS_RR", None)
    return out


def phase_default(device, smi):
    """The decomposed banded SDP at the north-star settings: Anderson
    acceleration, the refine latch and the df32 block KKT, through the
    Jacobi kernel. One first solve in float32; then a second float32 solve
    on the same model with two profiled windows of iterations under the
    sync debug mode "warn" (which slows it: its time is not reported). The
    float64 solve of this phase is left out for the run's time."""
    import warnings

    import torch
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems
    from cosmo_tpu_torch.profile_slice import IterationWindows

    data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    out = {}
    model = pt.Model(pt.Settings(**NORTHSTAR), device=device).set(*data)
    res, counts = counted_optimize(model)
    out["float32"] = _check_default(model, res, counts, "float32", "cold", 1e-4, smi)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        windows = IterationWindows(caught)
        try:
            res = model.optimize(on_iter=windows)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = [w for w in caught if "synchroniz" in str(w.message)]
    latch = (len(caught) if windows.warned_at_latch is None
             else windows.warned_at_latch)
    per = windows.close(res.iter)
    out["float32_profiled"] = dict(
        status=res.status, iter=res.iter, windows=per, flagged_syncs=len(flagged),
        flagged_before_latch=latch, syncs=model.last_solve["syncs"])
    log(f"[default] float32 profiled: {res.status}, {res.iter} iters; device "
        f"operations an iteration {per}; torch-flagged synchronizing calls "
        f"{len(flagged)} ({latch} before the latch), solver host waits "
        f"{model.last_solve['syncs']} [{smi}]")
    if res.status != "Solved" or set(per) != {"plain", "refined"}:
        raise AssertionError(f"default float32 profiled run: {res.status}, {per}")
    return out


def _check_default(model, res, counts, name, run, rel, smi):
    """Log one north-star solve and hold it to the contract of phase 6."""
    from cosmo_tpu_torch.profile_slice import host_waits

    info = model.last_solve
    err = abs(res.obj_val - REF_BANDED) / abs(REF_BANDED)
    ips = res.iter / info["iter_time"]
    iters = res.iter
    latch = info["refine_iter"]
    hist = res.info.res_history
    waits = host_waits(info, iters)
    log(f"[default] {name} {run}: {res.status}, {iters} iters ({res.safeguarding_iter} "
        f"safeguarding), {info['n_accelerated']} accelerated, refine latch at "
        f"iteration {latch}, obj {res.obj_val:.12f} (rel err {err:.2e}, limit "
        f"{rel:.0e}), setup {res.times.setup_time:.3f} s, solve {info['iter_time']:.3f} s, "
        f"{ips:.1f} iter/s, host waits an iteration {waits}, KKT {info['kkt_solver']}, PSD backend "
        f"{info['bucket_backends']}, launches {counts} / projections "
        f"{info['projections']} [{smi}]")
    if res.status != "Solved" or not err <= rel:
        raise AssertionError(f"default {name}: {res.status}, obj {res.obj_val}")
    if info["kkt_solver"] != "blockdiag" or info["bucket_backends"] != ("pallas",):
        raise AssertionError(f"default {name} left the main path: {info}")
    if not counts["jacobi_proj"] == info["projections"] > 0 or counts["jacobi_proj_rr"]:
        raise AssertionError(f"default {name}: {counts} kernel launches for "
                             f"{info['projections']} projections")
    if name == "float32" and not (latch > 0 and hist[-1, 5] == 1.0
                                  and info["n_accelerated"] > 0):
        raise AssertionError(f"default float32: latch {latch}, last history row "
                             f"{hist[-1]}, {info['n_accelerated']} accelerated")
    return dict(status=res.status, iter=iters, safeguarding_iter=res.safeguarding_iter,
                n_accelerated=info["n_accelerated"], refine_iter=latch, obj=res.obj_val,
                rel_err=err, setup_s=res.times.setup_time, solve_s=info["iter_time"],
                iter_per_s=ips, syncs=info["syncs"], refine_syncs=info["refine_syncs"],
                host_waits_per_iter=waits,
                launches=counts["jacobi_proj"], projections=info["projections"])


def _maxcut_path(model, counts, label):
    """Hold a maxcut solve to this slice's path: the Jacobi kernel on
    exactly one bucket, of side 8 and the largest batch, on every
    projection; the polar on every other bucket; the block KKT. Returns the
    PSD buckets as (batch, side, layout, backend) and the block KKT's
    buckets as (N, k, R) (R = 0: the COO applies instead of dense A)."""
    info = model.last_solve
    cones, kkt = model._dev_cache["cones"], model._dev_cache["kkt_block"]
    psd = [(b.batch, b.side, b.fastpath, b.backend or cones.eigh_backend)
           for b in cones.psd_buckets]
    blocks = [(b.N, b.k, b.R) for b in kkt.buckets]
    kernel = [p for p in psd if p[3] == "pallas"]
    small = max((p for p in psd if p[1] <= 16), key=lambda p: p[0])
    if (info["kkt_solver"] != "blockdiag" or kernel != [small] or small[1] != 8
            or any(p[3] != "polar" for p in psd if p is not small)):
        raise AssertionError(f"{label} left the main path: {psd}, {info['kkt_solver']}")
    if not counts["jacobi_proj"] == info["projections"] > 0 or counts["jacobi_proj_rr"]:
        raise AssertionError(f"{label}: {counts} kernel launches for "
                             f"{info['projections']} projections")
    return psd, blocks


def slack_lambda_min(x, L, device):
    """lambda_min of maxcut's dual slack diag(x) - L/4, formed densely in
    float64 on ``device`` from the scipy Laplacian ``L``."""
    import torch

    n = L.shape[0]
    Lc = L.tocoo()
    S = torch.zeros((n, n), dtype=torch.float64, device=device)
    S.index_put_((torch.as_tensor(Lc.row, device=device),
                  torch.as_tensor(Lc.col, device=device)),
                 torch.as_tensor(-Lc.data / 4.0, dtype=torch.float64, device=device),
                 accumulate=True)
    S.diagonal().add_(torch.as_tensor(x, dtype=torch.float64, device=device))
    return torch.linalg.eigvalsh(S)[0].item()


def phase_maxcut(device, smi):
    """The decomposed maxcut SDP in float32: maxcut-10k at
    ``_bench_maxcut10k``'s settings (the literal north star of
    BASELINE.json) with 20 plain and 20 refined iterations profiled, held
    to lambda_min(diag(x) - L/4) >= -1e-3. The maxcut-2000 solve of earlier
    runs is left out for the run's time (its [1729, 8] kernel shape stays
    in phase 3; tests/test_torch_maxcut.py holds maxcut to the JAX package
    on the CPU)."""
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems
    from cosmo_tpu_torch.profile_slice import IterationWindows, host_waits

    out = {}
    n_nodes = 10000
    label = f"maxcut-{n_nodes}"
    t0 = time.perf_counter()
    P, q, A, b, sets, L = problems.maxcut(n_nodes, 4.0 / n_nodes, seed=0, sparse=True)
    gen_s = time.perf_counter() - t0
    model = pt.Model(pt.Settings(**MAXCUT10K), device=device).set(P, q, A, b, sets)
    windows = IterationWindows()
    res, counts = counted_optimize(model, on_iter=windows)
    info, t = model.last_solve, res.times
    psd, blocks = _maxcut_path(model, counts, label)
    layouts = {p[2] for p in psd}
    ips = res.iter / info["iter_time"]
    row = dict(status=res.status, iter=res.iter, obj=res.obj_val,
               safeguarding_iter=res.safeguarding_iter,
               n_accelerated=info["n_accelerated"], refine_iter=info["refine_iter"],
               gen_s=gen_s, graph_s=t.graph_time, setup_s=t.setup_time,
               solve_s=info["iter_time"], post_s=t.post_time, iter_per_s=ips,
               host_waits_per_iter=host_waits(info, res.iter),
               launches=counts["jacobi_proj"], projections=info["projections"],
               psd_buckets=psd, kkt_buckets=blocks)
    log(f"[maxcut] {label} float32: {res.status}, {res.iter} iters "
        f"({res.safeguarding_iter} safeguarding), {info['n_accelerated']} accelerated, "
        f"refine latch at iteration {info['refine_iter']}, obj {res.obj_val:.10f}, "
        f"generated {gen_s:.2f} s, graph {t.graph_time:.3f} s, setup "
        f"{t.setup_time:.3f} s, solve {info['iter_time']:.3f} s, {ips:.1f} iter/s, post "
        f"{t.post_time:.3f} s, host waits an iteration {row['host_waits_per_iter']}, "
        f"launches {counts} / projections {info['projections']} [{smi}]")
    log(f"[maxcut] {label} PSD buckets (B, side, layout, backend) {psd}; block KKT "
        f"buckets (N, k, R; R = 0: COO applies) {blocks}")
    if res.status != "Solved":
        raise AssertionError(f"{label}: {res.status}")
    per = windows.close(res.iter)
    row["windows"] = per
    log(f"[maxcut] {label} device operations an iteration {per}")
    if not {"shear", "colpad"} <= layouts or (1, 896, "colpad", "polar") not in psd:
        raise AssertionError(f"{label}: layouts {psd}")
    # the independent check: the dual slack diag(x) - L/4 is PSD
    t1 = time.perf_counter()
    lam = slack_lambda_min(res.x, L, device)
    row.update(lambda_min=lam, sum_x=float(np.sum(res.x, dtype=np.float64)),
               eigvalsh_s=time.perf_counter() - t1)
    log(f"[maxcut] {label}: lambda_min(diag(x) - L/4) {lam:.3e} (limit -1e-03), "
        f"1'x {row['sum_x']:.10f}, eigvalsh {row['eigvalsh_s']:.2f} s")
    if not lam >= -1e-3:
        raise AssertionError(f"{label}: lambda_min {lam}")
    out[label] = row
    return out


def portfolio_checks(P, q, A, b, k, res, opt, eps=PORTFOLIO["eps_abs"]):
    """float64 host checks of a portfolio solution z = [x; y]: against the
    solver's own stopping rule (unscaled inf-norms, eps_abs = eps_rel =
    ``eps``) with twice its room, ||Az + s - b|| <= 2 (eps + eps
    max(||Az||, ||s||, ||b||)) and ||Pz + q + A'y_dual|| <= 2 (eps + eps
    max(||Pz||, ||q||, ||A'y_dual||)); s in the cones to 1e-12; the
    returned objective equal to 1/2 z'Pz + q'z to 1e-9; the duality gap
    z'Pz + q'z + b'y_dual + sum over the box rows of max(0, -y_dual) (the
    support function of [0, 1]) within PORTFOLIO_GAP_TOL of the objective;
    and the objective within twice that gap (plus 1e-4 relative) of the
    optimum ``opt``. Returns (the measured values, whether the checks
    hold)."""
    z, yd, s = (np.asarray(v, np.float64) for v in (res.x, res.y, res.s))
    Az, Pz, Aty = A @ z, P @ z, A.T @ yd
    prim = np.abs(Az + s - b).max()
    prim_limit = 2.0 * (eps + eps * max(np.abs(Az).max(), np.abs(s).max(), np.abs(b).max()))
    cone = max(np.abs(s[:k + 1]).max(), max(-s[k + 1:].min(), s[k + 1:].max() - 1.0, 0.0))
    stat = np.abs(Pz + q + Aty).max()
    stat_limit = 2.0 * (eps + eps * max(np.abs(q).max(), np.abs(Pz).max(),
                                        np.abs(Aty).max()))
    obj = 0.5 * z @ Pz + q @ z
    gap = z @ Pz + q @ z + b @ yd + np.maximum(0.0, -yd[k + 1:]).sum()
    checks = dict(prim=float(prim), prim_limit=float(prim_limit), cone=float(cone),
                  stat=float(stat), stat_limit=float(stat_limit),
                  obj_host_rel=float(abs(res.obj_val - obj) / abs(obj)),
                  rel_gap=float(gap / abs(obj)),
                  rel_err=float((res.obj_val - opt) / abs(opt)),
                  rel_err_limit=float((2.0 * abs(gap) + 1e-4 * abs(opt)) / abs(opt)))
    ok = bool(prim <= prim_limit and cone <= 1e-12 and stat <= stat_limit
              and checks["obj_host_rel"] <= 1e-9
              and abs(checks["rel_gap"]) <= PORTFOLIO_GAP_TOL
              and abs(checks["rel_err"]) <= checks["rel_err_limit"])
    return checks, ok


def phase_cg(device, smi, seed):
    """Phase 8: the banded SDP through CG (a), the portfolio QP made from
    ``seed`` through the auto CG route with a re-solve (b), its chunked
    solve (c) and verbose_timing (d)."""
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems
    from cosmo_tpu_torch import solver as solver_mod
    from cosmo_tpu_torch.models.model import refine_hint
    from cosmo_tpu_torch.profile_slice import host_waits
    from cosmo_tpu_torch.settings import split_settings

    out = {}
    # (a) the decomposed banded SDP through Coo + CG
    data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    model = pt.Model(pt.Settings(**BANDED_CG), device=device).set(*data)
    res, counts = counted_optimize(model)
    info, t = model.last_solve, res.times
    err = abs(res.obj_val - REF_BANDED) / abs(REF_BANDED)
    ips = res.iter / info["iter_time"]
    waits = host_waits(info, res.iter)
    row = dict(status=res.status, iter=res.iter, safeguarding_iter=res.safeguarding_iter,
               obj=res.obj_val, rel_err=err, refine_iter=info["refine_iter"],
               n_accelerated=info["n_accelerated"],
               kkt_solver_iters=info["kkt_solver_iters"],
               cg_per_iter=info["kkt_solver_iters"] / max(res.iter, 1),
               kkt_reads=info["kkt_reads"], setup_s=t.setup_time, graph_s=t.graph_time,
               solve_s=info["iter_time"], iter_per_s=ips, host_waits_per_iter=waits,
               launches=counts["jacobi_proj"], projections=info["projections"])
    out["banded_cg"] = row
    log(f"[cg] banded_sdp(10000, 8) float32 through CG: {res.status}, {res.iter} iters "
        f"({res.safeguarding_iter} safeguarding), {info['n_accelerated']} accelerated, "
        f"refine latch at iteration {info['refine_iter']}, obj {res.obj_val:.12f} (rel "
        f"err {err:.2e}, limit 1e-04); CG steps {info['kkt_solver_iters']} = "
        f"{row['cg_per_iter']:.2f} an iteration, CG reads {info['kkt_reads']}; graph "
        f"{t.graph_time:.3f} s, setup {t.setup_time:.3f} s, solve {info['iter_time']:.3f} s, "
        f"{ips:.2f} iter/s, host waits an iteration {waits}; KKT {info['kkt_solver']}, A "
        f"{info['A_layout']}, PSD backend {info['bucket_backends']}, launches {counts} / "
        f"projections {info['projections']} [{smi}]")
    if res.status != "Solved" or not err <= 1e-4:
        raise AssertionError(f"banded cg: {res.status}, obj {res.obj_val}")
    if (info["kkt_solver"] != "cg" or info["A_layout"] != "Coo"
            or model._dev_cache["kkt_precond"] is None
            or info["bucket_backends"] != ("pallas",) or info["kkt_refine_steps"] != 1
            or not info["refine_iter"] > 0):
        raise AssertionError(f"banded cg left its path: {info}")
    if not counts["jacobi_proj"] == info["projections"] > 0 or counts["jacobi_proj_rr"]:
        raise AssertionError(f"banded cg: {counts} kernel launches for "
                             f"{info['projections']} projections")

    # (b) the portfolio QP: cold at gamma = 1, then warm re-solves
    k = PORTFOLIO_K
    t0 = time.perf_counter()
    P, q, A, b, sets = problems.portfolio(k, 1.0, seed=seed)
    _, _, mu = problems.portfolio_data(k, seed=seed)
    gen_s = time.perf_counter() - t0
    model = pt.Model(pt.Settings(**PORTFOLIO), device=device).set(P, q, A, b, sets)
    runs = {}

    def solve(label, gamma, qv):
        res = model.optimize()
        info, t = model.last_solve, res.times
        opt = (PORTFOLIO_OPT[gamma] if seed == 0
               else problems.portfolio_optimum(k, gamma, seed)[0])
        checks, ok = portfolio_checks(P, qv, A, b, k, res, opt)
        row = dict(status=res.status, iter=res.iter, safeguarding_iter=res.safeguarding_iter,
                   obj=res.obj_val, optimum=opt, kkt_solver=info["kkt_solver"],
                   kkt_solver_iters=info["kkt_solver_iters"],
                   cg_per_iter=info["kkt_solver_iters"] / max(res.iter, 1),
                   kkt_reads=info["kkt_reads"], refine_iter=info["refine_iter"],
                   setup_s=t.setup_time, solve_s=info["iter_time"],
                   iter_per_s=res.iter / info["iter_time"],
                   host_waits_per_iter=host_waits(info, res.iter), checks=checks,
                   checks_ok=ok)
        runs[label] = row
        log(f"[cg] portfolio k={k} {label}: {res.status}, {res.iter} iters, obj "
            f"{res.obj_val:.10f} ({checks['rel_err']:.2e} relative of the optimum {opt!r}, "
            f"limit {checks['rel_err_limit']:.2e}: twice the duality gap "
            f"{checks['rel_gap']:.2e}, limit {PORTFOLIO_GAP_TOL:.0e}), KKT "
            f"{info['kkt_solver']}, CG steps "
            f"{info['kkt_solver_iters']} ({row['cg_per_iter']:.1f} an iteration, reads "
            f"{info['kkt_reads']}), refine latch at {info['refine_iter']}, setup "
            f"{t.setup_time:.3f} s, solve {info['iter_time']:.3f} s, "
            f"{row['iter_per_s']:.2f} iter/s, host waits an iteration "
            f"{row['host_waits_per_iter']}, checks {checks} [{smi}]")
        if res.status != "Solved" or info["kkt_solver"] != "cg" or not ok:
            raise AssertionError(f"portfolio {label}: {res.status}, {info['kkt_solver']}, "
                                 f"obj {res.obj_val} against {opt}, {checks}")
        return res

    cold = solve("gamma=1 cold", 1.0, q)
    runs["gamma=1 cold"]["gen_s"] = gen_s
    if seed == 0:
        err = (cold.obj_val - REF_PORTFOLIO) / abs(REF_PORTFOLIO)
        runs["gamma=1 cold"]["rel_to_reference"] = err
        log(f"[cg] portfolio gamma=1: {err:.2e} relative of the JAX package's "
            f"{REF_PORTFOLIO!r} at the same settings (itself "
            f"{(REF_PORTFOLIO - PORTFOLIO_OPT[1.0]) / abs(PORTFOLIO_OPT[1.0]):.2e} of the "
            f"optimum)")

    # (c) the problem's first CHUNKED_ITERS iterations in chunks of CHUNK
    # through the carry, against the same iterations in one call (the whole
    # solve in chunks of earlier runs is cut to this depth for the run's
    # time)
    import torch

    dev = model._dev_cache
    m, n = model.model_size
    static, dyn = split_settings(model._resolved_settings, m, n, dev["qd"].dtype,
                                 refine_hint=refine_hint(sets), device=device)
    dyn = dyn._replace(max_iter=torch.full_like(dyn.max_iter, CHUNKED_ITERS))
    args = (dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], dev["cones"], dev["x0"],
            dev["s0"], dev["mu0"], dyn, static)
    t1 = time.perf_counter()
    straight = solver_mod.solve(*args)
    straight_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    chunked = solver_mod.solve_chunked(*args, chunk=CHUNK)
    chunk_s = time.perf_counter() - t1
    rel = abs(chunked["cost"] - straight["cost"]) / abs(straight["cost"])
    same = bool(np.array_equal(chunked["x"], straight["x"]))
    out["chunked"] = dict(status=chunked["status"], iter=chunked["iter"],
                          obj=chunked["cost"], rel_to_uninterrupted=rel, solve_s=chunk_s,
                          uninterrupted_s=straight_s,
                          kkt_solver_iters=chunked["kkt_solver_iters"], x_bit_identical=same)
    log(f"[cg] portfolio gamma=1, its first {CHUNKED_ITERS} iterations in chunks of {CHUNK}: "
        f"status {chunked['status']}, {chunked['iter']} iters (uninterrupted "
        f"{straight['iter']}, status {straight['status']}), CG steps "
        f"{chunked['kkt_solver_iters']} (uninterrupted {straight['kkt_solver_iters']}), obj "
        f"{chunked['cost']:.12f}, rel {rel:.2e} of the uninterrupted (limit 1e-05), x "
        f"bit-identical {same}, {chunk_s:.3f} s (uninterrupted {straight_s:.3f} s)")
    if (chunked["status"] != straight["status"] or chunked["iter"] != straight["iter"]
            or not rel <= 1e-5):
        raise AssertionError(f"chunked portfolio: {out['chunked']}")

    # the re-solve: update(q) and a warm start from the cold solution, (d)
    # with the phase timers on
    qv = problems.portfolio_q(mu, k, PORTFOLIO_GAMMA)
    model.update(q=qv).warm_start(x0=cold.x, y0=cold.y, s0=cold.s)
    model.settings = model.settings.replace(verbose_timing=True)
    warm = solve(f"gamma={PORTFOLIO_GAMMA:g} warm", PORTFOLIO_GAMMA, qv)
    times = warm.times
    timers = {n_: getattr(times, n_) for n_ in (
        "scaling_time", "init_factor_time", "factor_update_time", "proj_time",
        "update_time", "accelerate_time")}
    out["verbose_timing"] = timers
    log(f"[cg] verbose_timing of the gamma={PORTFOLIO_GAMMA:g} re-solve: {timers}")
    log(f"[cg] portfolio k={k}: generated in {gen_s:.2f} s")
    # CG has no factor: its two factor timers are 0.0 by the reference's rule
    if not all(np.isfinite(v) for v in timers.values()) or not all(
            timers[n_] > 0 for n_ in ("scaling_time", "proj_time", "update_time",
                                      "accelerate_time")):
        raise AssertionError(f"verbose_timing: {timers}")
    log("[cg] portfolio iterations, cold gamma=1 against warm: " + ", ".join(
        f"{lab} {r['iter']}" for lab, r in runs.items()))
    out["portfolio"] = runs
    return out


def phase_known_answers(device):
    """The known answers of the verify notes, float64 on ``device``."""
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    plain = dict(accelerator=None, decompose=False, dtype=np.float64)

    def model(**kw):
        return pt.Model(pt.Settings(**dict(plain, **kw)), device=device)

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    qp = model().assemble(P, [1.0, 1.0], [pt.Constraint(
        A, np.zeros(3), pt.Box([1.0, 0.0, 0.0], [1.0, 0.7, 0.7]))]).optimize()

    n = 4
    lp = model(sparse=False, eps_abs=1e-4).assemble(np.zeros((n, n)), [1.0, 2.0, 3.0, 4.0], [
        pt.Constraint(-np.eye(n), np.full(n, 10.0), pt.Nonnegatives),
        pt.Constraint(np.eye(n), -np.ones(n), pt.Nonnegatives),
        pt.Constraint([[1.0]], [-5.0], pt.Nonnegatives, n, [1]),
        pt.Constraint([[1.0, 0.0, 1.0, 0.0]], [-4.0], pt.Nonnegatives),
    ]).optimize()

    C = np.array([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 4.0]])
    d = 6
    sdp = model().assemble(np.zeros((d, d)), problems.svec(C), [
        pt.Constraint(problems.svec(np.eye(3))[None, :], [-1.0], pt.ZeroSet),
        pt.Constraint(np.eye(d), np.zeros(d), pt.PsdConeTriangle),
    ]).optimize()

    inf = model(sparse=False).assemble(np.zeros((3, 3)), np.ones(3), [
        pt.Constraint(np.eye(3), -np.ones(3), pt.Nonnegatives),
        pt.Constraint(-np.eye(3), np.zeros(3), pt.Nonnegatives),
    ]).optimize()

    checks = {
        "qp": qp.status == "Solved" and np.abs(qp.x - [0.3, 0.7]).max() < 1e-3
        and abs(qp.obj_val - 1.88) < 1e-3,
        "lp": lp.status == "Solved" and np.abs(lp.x - [3, 5, 1, 1]).max() < 1e-2
        and abs(lp.obj_val - 20.0) < 1e-2,
        "min_eig": sdp.status == "Solved"
        and bool(abs(sdp.obj_val - np.linalg.eigvalsh(C)[0]) < 1e-3),
        "infeasible_lp": inf.status == "Primal_infeasible",
    }
    for name, r in (("qp", qp), ("lp", lp), ("min_eig", sdp), ("infeasible_lp", inf)):
        log(f"[known] {name}: {r.status}, obj {r.obj_val:.6g}, x {np.round(r.x, 4)} "
            f"{'ok' if checks[name] else 'FAIL'}")
    if not all(checks.values()):
        raise AssertionError(f"known answers failed: {checks}")
    return checks


# the exp/pow kernel vs its plain version, relative to max |V| (tests/
# test_torch_cuda.py): float64 the same operations, CUDA's log, exp and pow
# other in the last bits; float32 exp to 1e-4; float32 pow to 1e-4 on all
# but 1 row in 1,000, where the reference's float32 Newton keeps no digit
# (phic's square root cancels: its float32 and float64 runs differ by up
# to 1.4 there, and a host build of the kernel body differs from the plain
# version by up to 1.2e-2 of max |V| on 3 of 65,122 rows)
CONE_TOL = {"float32": 1e-4, "float64": 1e-10}
CONE_ALPHAS = (0.3, 0.5, 0.8)
CONE_SIZES = (1, 1000, 65122)       # 65,122: the exp cones of 9a
# operations a lane does, transcendental functions counted as one: an
# exp Newton step (the f and f' of the inner solve, the step, its guards),
# an evaluation of g(lambda) around it with its bisection update, a pow
# Newton step (two phic, two powers, the derivative, the clipped step),
# a pow end point (two phic and z), and a row's case tests
EXP_OPS = dict(newton=24, evals=23, rows=20)
POW_OPS = dict(newton=47, evals=25, rows=45)


def cone_points(n, dtype, device, seed):
    """Rows covering the four cases of both projections (a Gaussian times
    a scale from e^-3 to e^3 a row, every 20th row with |z| = 1e-9), half
    dual, tolerances 1e-8 and 1e-6, made from ``seed``."""
    import torch

    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-3, 3, (n, 1)))
    V[::20, 2] = 1e-9 * np.sign(V[::20, 2])
    to = dict(dtype=dtype, device=device)
    return (torch.as_tensor(V, **to), torch.as_tensor(rng.random(n) < 0.5, device=device),
            torch.as_tensor(np.where(rng.random(n) < 0.5, 1e-8, 1e-6), **to))


def cone_bound_ms(stats, ops, n, dtype_name, with_alpha):
    """Least time of a projection on an H100: the larger of its operations
    (``stats`` of the plain version on these rows, ``ops`` a unit) at the
    card's peak for the type, and its bytes (V, tolerance, dual flag and
    alpha read once, the rows written once) at the memory rate."""
    itemsize = 4 if dtype_name == "float32" else 8
    flops = sum(ops[k] * stats.get(k, 0) for k in ops)
    nbytes = n * (itemsize * (3 + 1 + 3 + int(with_alpha)) + 1)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_cone_kernel(device, sizes=CONE_SIZES, reps=10):
    """The exp/pow kernel vs its plain version: float32 and float64, primal
    and dual rows, pow at alpha in ``CONE_ALPHAS``, N in ``sizes``. At the
    largest N (the 9a path's exp cones) each entry is timed (kernel
    ``launch_ms`` and ``device_ms``, plain ``launch_ms``) and bounded."""
    import torch
    from cosmo_tpu_torch.kernel_timing import device_ms, launch_ms
    from cosmo_tpu_torch.ops import exp_pow as E
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    rows = []
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        for n in sizes:
            V, dual, tol = cone_points(n, dtype, device, seed=n)
            scale = V.abs().max().item()
            timed = n == max(sizes)
            cases = [("exp", None)] + [("pow", a) for a in CONE_ALPHAS]
            for family, a in cases:
                if family == "exp":
                    args, ops, it = (V, dual, tol), EXP_OPS, 100
                    launch, plain = K.exp_proj_cuda, E.project_exp_plain
                else:
                    alpha = torch.full((n,), a, dtype=dtype, device=device)
                    args, ops, it = (V, alpha, dual, tol), POW_OPS, 20
                    launch, plain = K.pow_proj_cuda, E.project_pow_plain
                got = launch(*args, it)
                torch.cuda.synchronize()
                stats = {}
                ref = plain(*args, it, stats=stats)
                # a NaN where the plain version has one is agreement
                nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
                diff = torch.where(torch.isnan(got) & torch.isnan(ref), 0.0, got - ref)
                err_rows = diff.abs().amax(1) / scale
                err = err_rows.max().item() * scale
                over = int((~(err_rows <= CONE_TOL[dtype_name])).sum().item())
                if family == "pow" and dtype_name == "float32":
                    ok = over <= max(1, n // 1000)
                else:
                    ok = over == 0
                ok = ok and nan_same
                bound_ms, bound_by = cone_bound_ms(stats, ops, n, dtype_name,
                                                   family == "pow")
                row = dict(kernel=f"exp_pow_proj/{family}", dtype=dtype_name, N=n,
                           alpha=a, max_abs_err=err, max_abs_x=scale,
                           tol_rel=CONE_TOL[dtype_name], rows_over=over, ok=ok,
                           stats=stats, bound_ms=bound_ms, bound_by=bound_by,
                           ms=launch_ms(lambda: launch(*args, it), reps) if timed else None,
                           device_ms=(device_ms(lambda: launch(*args, it), reps)
                                      if timed else None),
                           plain_ms=(launch_ms(lambda: plain(*args, it), 2) if timed
                                     else None),
                           library_ms=None)
                rows.append(row)
                times = ("" if not timed else f" ms={row['ms']:.4f} device="
                         f"{row['device_ms']:.4f} plain={row['plain_ms']:.2f}")
                log(f"[kernel] exp_pow_proj/{family}{'' if a is None else f' a={a}'} "
                    f"{dtype_name} N={n:5d} err={err:.3e} (tol {CONE_TOL[dtype_name]:.0e}"
                    f"*{scale:.2f}, rows over {over}) lane work {stats}{times} "
                    f"bound={bound_ms:.5f} ({bound_by}) {'ok' if ok else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"the exp/pow kernel disagrees with its plain version: {bad}")
    return rows


def phase_plugins(device, smi):
    """Phase 4's additions, float64: the QP through the one-call
    ``solve`` with a cone dict, a problem with a ``CustomCone`` (the
    nonnegative orthant in torch ops), one with a ``CustomKKTSolver`` whose
    solve calls ``torch.linalg.solve``, and the power cone's known answer
    (z* = 2^a 3^(1-a), one counted launch of the pow kernel a projection)."""
    import torch
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [-1.0, -1.0], [-1.0, 0], [0, -1.0]])
    b = np.array([1.0, 0.7, 0.7, -1.0, 0.0, 0.0])
    f64 = dict(eps_abs=1e-8, eps_rel=1e-8, dtype=np.float64)
    qp = pt.solve(P, [1.0, 1.0], A, b, {"l": 6}, device=device, **f64)
    ref = pt.Model(pt.Settings(**f64), device=device).set(
        P, [1.0, 1.0], A, b, [pt.Nonnegatives(6)]).optimize()
    custom = pt.Model(pt.Settings(**f64), device=device).set(
        P, [1.0, 1.0], A, b, [pt.CustomCone(dim=6, project=lambda v: torch.clamp(v, min=0.0),
                                            scalar_scaling=False)]).optimize()

    def setup(Pm, Am, sigma, rho):
        return Pm + sigma * torch.eye(Pm.shape[0], dtype=Pm.dtype, device=Pm.device) + (
            Am.T @ (rho[:, None] * Am))

    def solve(M, Pm, Am, sigma, rho, r1, r2):
        x = torch.linalg.solve(M, r1 + Am.T @ (rho * r2))
        return x, rho * (Am @ x - r2)

    kkt = pt.Model(pt.Settings(kkt_solver=pt.CustomKKTSolver(setup=setup, solve=solve),
                               **f64), device=device).set(
        P, [1.0, 1.0], A, b, [pt.Nonnegatives(6)]).optimize()
    alpha = 0.3
    K.project_pow.launches = 0
    pmodel = pt.Model(pt.Settings(dtype=np.float64), device=device).assemble(
        np.zeros((1, 1)), [-1.0], [pt.Constraint([[0.0], [0.0], [1.0]], [2.0, 3.0, 0.0],
                                                 pt.PowerCone(alpha))])
    pw = pmodel.optimize()
    pow_launches = K.project_pow.launches
    checks = {
        "solve_qp": qp.status == "Solved" and np.abs(qp.x - [0.3, 0.7]).max() < 1e-6
        and abs(qp.obj_val - ref.obj_val) < 1e-9,
        "custom_cone": custom.status == "Solved" and np.abs(custom.x - ref.x).max() < 1e-7,
        "custom_kkt": kkt.status == "Solved" and np.abs(kkt.x - ref.x).max() < 1e-7,
        "pow_cone": pw.status == "Solved"
        and abs(pw.x[0] - 2.0 ** alpha * 3.0 ** (1 - alpha)) < 1e-3
        and pow_launches == pmodel.last_solve["projections"] > 0,
    }
    for name, r in (("solve_qp", qp), ("custom_cone", custom), ("custom_kkt", kkt),
                    ("pow_cone", pw)):
        log(f"[known] {name}: {r.status}, {r.iter} iters, obj {r.obj_val:.10g}, x "
            f"{np.round(r.x, 6)} {'ok' if checks[name] else 'FAIL'}")
    log(f"[known] pow_cone: pow kernel launches {pow_launches} / projections "
        f"{pmodel.last_solve['projections']} [{smi}]")
    if not all(checks.values()):
        raise AssertionError(f"plug-in known answers failed: {checks}")
    return dict(checks=checks, pow_launches=pow_launches)


def tomography_problem(n_states, r, seed):
    """Least-squares quantum state estimation (Smolin, Gambetta and Smith,
    PRL 108, 070502, 2012) of ``n_states`` r x r density matrices at once:
    min 1/2 sum ||X_i - C_i||_F^2 s.t. tr X_i = 1, X_i Hermitian PSD, with
    C_i a random pure state plus Hermitian Gaussian noise (0.05), from
    ``seed``. X_i is packed as PsdConeTriangleComplex stores it (the real
    upper triangle, sqrt(2) off the diagonal, then the imaginary strict
    upper triangle times sqrt(2)): an isometry, so P = I. Returns (P, q, A,
    b, sets, C) in the internal ``Ax + s = b`` form (A sparse): the trace
    rows (ZeroSet), then one Hermitian cone a state."""
    import scipy.sparse as sp
    import cosmo_tpu_torch as pt

    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n_states, r)) + 1j * rng.standard_normal((n_states, r))
    psi /= np.linalg.norm(psi, axis=1, keepdims=True)
    G = rng.standard_normal((n_states, r, r)) + 1j * rng.standard_normal((n_states, r, r))
    C = np.einsum("bi,bj->bij", psi, psi.conj()) + 0.05 * (G + G.conj().swapaxes(1, 2)) / 2
    d = r * r
    n = n_states * d
    q = -np.concatenate([pack_hermitian(c) for c in C])
    diag = np.array([j * (j + 1) // 2 + j for j in range(r)])
    rows = np.repeat(np.arange(n_states), r)
    cols = (np.arange(n_states)[:, None] * d + diag[None, :]).ravel()
    A = sp.vstack([sp.csr_matrix((np.ones(n_states * r), (rows, cols)), shape=(n_states, n)),
                   -sp.identity(n, format="csr")], format="csr")
    b = np.concatenate([np.ones(n_states), np.zeros(n)])
    sets = [pt.ZeroSet(n_states)] + [pt.PsdConeTriangleComplex(d) for _ in range(n_states)]
    return sp.identity(n, format="csr"), q, A, b, sets, C


def pack_hermitian(H):
    r = H.shape[0]
    re = [H[i, j].real * (1.0 if i == j else np.sqrt(2.0))
          for j in range(r) for i in range(j + 1)]
    im = [H[i, j].imag * np.sqrt(2.0) for j in range(r) for i in range(j)]
    return np.array(re + im)


def simplex_projection(w):
    """The Euclidean projection of each row of ``w`` onto the probability
    simplex (sorting)."""
    u = -np.sort(-w, axis=1)
    css = np.cumsum(u, axis=1) - 1.0
    k = np.arange(1, w.shape[1] + 1)
    rho = (u - css / k > 0).sum(axis=1)
    theta = css[np.arange(w.shape[0]), rho - 1] / rho
    return np.maximum(w - theta[:, None], 0.0)


def tomography_closed_form(C):
    """argmin ||X - C||_F over Hermitian PSD X of unit trace: C's
    eigenvalues projected onto the simplex (numpy, float64, on the host)."""
    w, V = np.linalg.eigh(C)
    wp = simplex_projection(w)
    return np.stack([pack_hermitian(X) for X in np.einsum("bik,bk,bjk->bij", V, wp,
                                                          V.conj())])


def phase_cones(device, smi, seed):
    """9a logistic_a9a, 9b block_sdp_8x256_mixed, 9c hermitian_tomography."""
    return dict(logistic=phase_logistic(device, smi, seed),
                mixed=phase_mixed(device, smi),
                tomography=phase_tomography(device, smi, seed))


def phase_logistic(device, smi, seed):
    """9a: L2-regularised logistic regression through 65,122 exponential
    cones at the shape of LIBSVM's a9a (32,561 samples, 123 binary
    features, 14 set a sample, lam = 0.5: C = 1), made from ``seed``,
    float64, defaults (Anderson, rho adaptation, the auto Coo + CG route),
    eps 1e-5. Held to: Solved; one counted exp kernel launch a projection;
    the returned weights' loss within 1e-4 of ``logistic_optimum`` (Newton
    on the host); the gradient there at most 1e-3 of its value at w = 0;
    the objective within twice the solve's duality gap of the optimum (at
    eps 1e-5 each of the 32,561 t_i may sit below its softplus by the
    residual: both packages land 1.9e-4 below at the example's size)."""
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    n, d = LOGISTIC["n_samples"], LOGISTIC["n_features"]
    t0 = time.perf_counter()
    P, q, A, b, sets, (Z, y) = problems.logistic_regression(
        n, d, LOGISTIC["nnz"], lam=LOGISTIC["lam"], seed=seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_opt, _ = problems.logistic_optimum(Z, y, LOGISTIC["lam"])
    opt_s = time.perf_counter() - t0
    model = pt.Model(pt.Settings(**LOGISTIC_SETTINGS), device=device).set(P, q, A, b, sets)
    res, counts = counted_optimize(model)
    info = model.last_solve
    x = res.x
    loss, g = problems.logistic_loss(Z, y, LOGISTIC["lam"], x[:d])
    _, g0 = problems.logistic_loss(Z, y, LOGISTIC["lam"], np.zeros(d))
    gap = abs(x @ (P @ x) + q @ x + b @ res.y)
    ips = res.iter / info["iter_time"]
    out = dict(status=res.status, iter=res.iter, obj=res.obj_val, f_opt=f_opt,
               obj_rel_err=(res.obj_val - f_opt) / f_opt, gap=gap,
               loss_rel_err=(loss - f_opt) / f_opt,
               grad_ratio=float(np.abs(g).max() / np.abs(g0).max()),
               solve_s=info["iter_time"], iter_per_s=ips, setup_s=res.times.setup_time,
               gen_s=gen_s, opt_s=opt_s, kkt_solver=info["kkt_solver"],
               cg_steps_per_iter=res.info.kkt_solver_iters / max(res.iter, 1),
               launches=counts["exp_pow_proj/exp"], projections=info["projections"],
               shape=(A.shape, A.nnz, len(sets) - 1))
    log(f"[cones] 9a logistic {n}x{d} (m {A.shape[0]}, n {A.shape[1]}, nnz {A.nnz}, "
        f"{len(sets) - 1} exp cones) float64: {res.status}, {res.iter} iters, obj "
        f"{res.obj_val:.10f} vs optimum {f_opt:.10f} (rel {out['obj_rel_err']:.2e}, "
        f"gap {gap:.3e}), loss(w) rel err {out['loss_rel_err']:.2e} (limit 1e-04), "
        f"grad ratio {out['grad_ratio']:.2e} (limit 1e-03), setup "
        f"{res.times.setup_time:.2f} s, solve {info['iter_time']:.2f} s, {ips:.1f} iter/s, "
        f"KKT {info['kkt_solver']} {out['cg_steps_per_iter']:.2f} CG steps an iteration, "
        f"exp kernel launches {counts['exp_pow_proj/exp']} / projections "
        f"{info['projections']}, generated {gen_s:.2f} s, optimum {opt_s:.2f} s [{smi}]")
    if res.status != "Solved":
        raise AssertionError(f"9a: {res.status}")
    if not counts["exp_pow_proj/exp"] == info["projections"] > 0:
        raise AssertionError(f"9a: {counts} launches for {info['projections']} projections")
    if not (abs(out["loss_rel_err"]) <= 1e-4 and out["grad_ratio"] <= 1e-3
            and abs(res.obj_val - f_opt) <= 2.0 * gap + 1e-9 * f_opt):
        raise AssertionError(f"9a: {out}")
    return out


def phase_mixed(device, smi, fixed_iters=300):
    """9b: bench.py's block_sdp_8x256_mixed_loose configuration, float32:
    block_sdp(8, 256, 256) through the polar projection with plain ADMM
    (no rho adaptation, scaling 10, checks every 25) and mixed_precision.
    At eps 1e-5 with one df32 KKT refinement step (``BLOCK8X256_MIXED``):
    Solved, the loose phase's latch tripped, the objective within 1e-4 of
    ``REF_BLOCK8X256``. Then at the fixed-work settings of bench.py (eps 0,
    its auto refinement, ``fixed_iters`` iterations) the loose phase
    (``mixed_precision_switch=0`` keeps it on) against full float32, in
    turns loose, full, full, loose."""
    import scipy.sparse as sp
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    P, q, A, b, sets = problems.block_sdp(n_blocks=8, side=256, n=256, seed=0)
    A = sp.csr_matrix(A)
    model = pt.Model(pt.Settings(**BLOCK8X256_MIXED), device=device).set(P, q, A, b, sets)
    res, _ = counted_optimize(model)
    info = model.last_solve
    err = abs(res.obj_val - REF_BLOCK8X256) / abs(REF_BLOCK8X256)
    out = dict(status=res.status, iter=res.iter, obj=res.obj_val, rel_err=err,
               loose_iter=info["loose_iter"], solve_s=info["iter_time"],
               iter_per_s=res.iter / info["iter_time"], A_layout=info["A_layout"],
               backends=info["bucket_backends"])
    log(f"[cones] 9b block_sdp(8,256,256) float32 mixed precision: {res.status}, "
        f"{res.iter} iters, loose phase until iteration {info['loose_iter']}, obj "
        f"{res.obj_val:.10f} (rel err {err:.2e} of {REF_BLOCK8X256}, limit 1e-04), "
        f"solve {info['iter_time']:.2f} s, {out['iter_per_s']:.1f} iter/s, A "
        f"{info['A_layout']}, PSD backend {info['bucket_backends']} [{smi}]")
    if res.status != "Solved" or not err <= 1e-4 or not info["loose_iter"] > 0:
        raise AssertionError(f"9b: {out}")
    fixed = dict(BLOCK8X256_MIXED, eps_abs=0.0, eps_rel=0.0, eps_prim_inf=0.0,
                 eps_dual_inf=0.0, max_iter=fixed_iters, kkt_refine_steps=-1)
    rates = {"loose": [], "full": []}
    for name in ("loose", "full", "full", "loose"):
        s = dict(fixed, mixed_precision_switch=0.0) if name == "loose" else dict(
            fixed, mixed_precision=False)
        m = pt.Model(pt.Settings(**s), device=device).set(P, q, A, b, sets)
        r = m.optimize()
        rates[name].append(r.iter / m.last_solve["iter_time"])
        if name == "loose" and m.last_solve["loose_iter"] != -1:
            raise AssertionError("9b: the fixed-work loose run left the loose phase")
    out["fixed_iter_per_s"] = rates
    log(f"[cones] 9b fixed work ({fixed_iters} iterations, eps 0): loose phase "
        f"{[round(v, 2) for v in rates['loose']]} iter/s, full float32 "
        f"{[round(v, 2) for v in rates['full']]} iter/s (loose/full "
        f"{np.mean(rates['loose']) / np.mean(rates['full']):.3f}) [{smi}]")
    return out


def phase_tomography(device, smi, seed, n_states=2048, r=8):
    """9c: least-squares state estimation of 2,048 3-qubit density
    matrices in PsdConeTriangleComplex(8), plain ADMM, float64 then
    float32: Solved; the embedded [2048, 16] bucket through jacobi_proj on
    every projection; each X_i within the solve's tolerance of the closed
    form (C_i's eigenvalues projected onto the simplex, numpy on the
    host): 10 eps of max |C| in float64, 1e-4 in float32 (the Jacobi
    kernel's float32 floor)."""
    import cosmo_tpu_torch as pt

    P, q, A, b, sets, C = tomography_problem(n_states, r, seed)
    Xref = tomography_closed_form(C)
    scale = np.abs(q).max()
    out = {}
    for dtype, tol in ((np.float64, 1e-4), (np.float32, 1e-4)):
        name = np.dtype(dtype).name
        model = pt.Model(pt.Settings(**dict(TOMOGRAPHY, dtype=dtype)), device=device).set(
            P, q, A, b, sets)
        res, counts = counted_optimize(model)
        info = model.last_solve
        cones = model._dev_cache["cones"]
        buckets = [(bk.batch, bk.side) for bk in cones.psd_buckets]
        err = float(np.abs(res.x.reshape(n_states, r * r) - Xref).max())
        out[name] = dict(status=res.status, iter=res.iter, obj=res.obj_val, max_err=err,
                         solve_s=info["iter_time"], iter_per_s=res.iter / info["iter_time"],
                         buckets=buckets, backends=info["bucket_backends"],
                         launches=counts["jacobi_proj"], projections=info["projections"],
                         kkt_solver=info["kkt_solver"])
        log(f"[cones] 9c tomography {n_states} x {r}x{r} {name}: {res.status}, {res.iter} "
            f"iters, max |x - closed form| {err:.3e} (limit {tol:.0e}*{scale:.3f}), solve "
            f"{info['iter_time']:.2f} s, {out[name]['iter_per_s']:.1f} iter/s, KKT "
            f"{info['kkt_solver']}, PSD buckets {buckets} {info['bucket_backends']}, "
            f"launches {counts} / projections {info['projections']} [{smi}]")
        if res.status != "Solved" or not err <= tol * max(1.0, scale):
            raise AssertionError(f"9c {name}: {out[name]}")
        if (buckets != [(n_states, 2 * r)] or info["bucket_backends"] != ("pallas",)
                or not counts["jacobi_proj"] == info["projections"] > 0):
            raise AssertionError(f"9c {name} left the path: {out[name]}")
    return out


# phase 10a: the warm-started Jacobi kernel's shapes (every even k of its
# domain at B in {1, 1000, 2498}, and the maxcut bucket's [8540, 8]) and the
# two timed at 2 (warm) and 8 (stale) sweeps: the banded path's [2498, 16]
# and [8540, 8]
EIG_SIDES = tuple(range(4, 49, 2))
EIG_BATCHES = (1, 1000, 2498)
EIG_TIMED = ((16, 2498), (8, 8540))
WARM_SWEEPS = 2


def eig_case(B, k, warm, dtype, device, seed):
    """(X, W, V0) of one amortized projection, made from ``seed``: X a
    symmetric Gaussian stack; warm, V0 its eigenbasis (numpy, float64)
    turned by a random orthogonal matrix near I (angles ~0.01: a block's
    off-diagonal mass stays a few percent of its energy, under the
    staleness rule's 9%) and W = V0' X V0 symmetrised; stale, V0 = I and
    W = X."""
    import torch

    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, k, k))
    X = (G + G.swapaxes(1, 2)) / 2
    if warm:
        R = rng.standard_normal((B, k, k)) * 0.01
        R, _ = np.linalg.qr(np.eye(k) + (R - R.swapaxes(1, 2)))
        V0 = np.linalg.eigh(X)[1] @ R
        W = V0.swapaxes(1, 2) @ X @ V0
        W = (W + W.swapaxes(1, 2)) / 2
    else:
        V0, W = np.broadcast_to(np.eye(k), (B, k, k)), X
    return tuple(torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
                 for a in (X, W, V0))


def eig_bound_ms(B, k, dtype_name, sweeps):
    """Least time of one warm-started Jacobi call on an H100: the larger of
    its flops at the card's peak for the type (n_pairs rotations a sweep,
    each 18k + 20 flops, then P = V max(w, 0) V', 2k^3, and its
    symmetrisation, k^2) and its bytes (W and V0 read once, P and V written
    once) at the memory rate. The kernel sums each entry of P twice, once
    for each side of the symmetrisation; the function needs one sum."""
    itemsize = 4 if dtype_name == "float32" else 8
    flops = B * (sweeps * (k - 1) * (k // 2) * (18 * k + 20) + 2 * k**3 + k**2)
    nbytes = 4 * B * k * k * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def eig_library(W, V0):
    """The same function through ``torch.linalg.eigh``: V = V0 Q, P = V
    max(w, 0) V' (the kernels line's ``library_ms``; the port never calls
    it)."""
    import torch

    w, Q = torch.linalg.eigh(W)
    V = V0 @ Q
    return V @ (torch.clamp(w, min=0.0)[:, :, None] * V.transpose(1, 2)), V


def eig_diffs(X, got, ref):
    """max |P - P_ref|, max |V - V_ref|, and max |R - R_ref| with R = V
    diag(V'XV) V': R does not change under rotations among eigenvectors of
    nearly equal eigenvalues, which float32 rounding does not determine."""
    import torch

    def rec(V):
        d = torch.diagonal(V.transpose(1, 2) @ X @ V, dim1=1, dim2=2)
        return V @ (d[:, :, None] * V.transpose(1, 2))

    return ((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item(),
            (rec(got[1]) - rec(ref[1])).abs().max().item())


def phase_eig_kernel(device, reps=20):
    """10a: the warm-started Jacobi kernel (jacobi_eig) against its plain
    version, float32 and float64, at every shape of ``EIG_SIDES`` by
    ``EIG_BATCHES`` and [8540, 8], one warm case (V0 near W's eigenbasis, 2
    sweeps) and one stale (V0 = I, 8 sweeps) each, each of which the
    backend's staleness rule (``eigh.amortized_rotate``) classes as such: P
    and V diag(V'XV) V' within ``TOL`` of max |X|, and in float64 V itself
    (max |V - V_ref| is logged for float32). At ``EIG_TIMED`` the kernel
    (``launch_ms`` and ``device_ms``), its plain version and
    ``eig_library`` are timed and bounded, and the torch part of the
    amortized projection before the kernel (``eigh.amortized_rotate``) is
    timed beside them."""
    import torch
    from cosmo_tpu_torch.kernel_timing import device_ms, launch_ms
    from cosmo_tpu_torch.ops import eigh as E
    from cosmo_tpu_torch.ops import jacobi_eig as JE

    rows = []
    shapes = [(k, B) for k in EIG_SIDES for B in EIG_BATCHES] + [(8, 8540)]
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for k, B in shapes:
            for warm in (True, False):
                X, W, V0 = eig_case(B, k, warm, dtype, device, seed=1000 * k + B + warm)
                stale = E.amortized_rotate(X, V0)[2]
                if bool(stale) == warm:
                    raise AssertionError(f"10a: the staleness rule calls the warm={warm} "
                                         f"case at k={k}, B={B} the other")
                sweeps = WARM_SWEEPS if warm else SWEEPS

                def kernel():
                    return JE.jacobi_eig_cuda(W, V0, stale, WARM_SWEEPS, SWEEPS)

                def plain():
                    return JE.jacobi_eig_plain(W, V0, stale, WARM_SWEEPS, SWEEPS)

                got = kernel()
                torch.cuda.synchronize()
                dP, dV, dR = eig_diffs(X, got, plain())
                scale = X.abs().max().item()
                ok = all(np.isfinite((dP, dV, dR))) and dP <= tol * scale and (
                    dR <= tol * scale) and (dtype_name == "float32" or dV <= tol * scale)
                timed = (k, B) in EIG_TIMED
                bound_ms, bound_by = eig_bound_ms(B, k, dtype_name, sweeps)
                row = dict(kernel="jacobi_eig", dtype=dtype_name, k=k, B=B, sweeps=sweeps,
                           max_abs_err=max(dP, dR) if dtype_name == "float32"
                           else max(dP, dV, dR), max_abs_err_P=dP, max_abs_err_V=dV,
                           max_abs_err_rec=dR, max_abs_x=scale, tol_rel=tol, ok=ok,
                           bound_ms=bound_ms, bound_by=bound_by,
                           ms=launch_ms(kernel, reps) if timed else None,
                           device_ms=device_ms(kernel, reps) if timed else None,
                           plain_ms=launch_ms(plain, 3) if timed else None,
                           library_ms=(launch_ms(lambda: eig_library(W, V0), reps)
                                       if timed else None),
                           rotate_ms=(launch_ms(lambda: E.amortized_rotate(X, V0), reps)
                                      if timed else None))
                rows.append(row)
                times = ("" if not timed else
                         f" ms={row['ms']:.4f} device={row['device_ms']:.4f} plain="
                         f"{row['plain_ms']:.3f} eigh={row['library_ms']:.3f} (torch "
                         f"rotation before the kernel {row['rotate_ms']:.4f})")
                log(f"[backends] jacobi_eig {dtype_name} k={k:2d} B={B:5d} sweeps={sweeps} "
                    f"err P {dP:.3e} V {dV:.3e} V diag(V'XV) V' {dR:.3e} (tol {tol:.0e}*"
                    f"{scale:.2f}){times} bound={bound_ms:.5f} ({bound_by}) "
                    f"{'ok' if ok else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"jacobi_eig disagrees with its plain version: {bad}")
    return rows


def phase_amortized(device, smi):
    """10b: the decomposed banded SDP at phase 5's settings (plain ADMM,
    float64) with eigh_backend="amortized": Solved within 1e-6 of
    ``REF_BANDED``, one jacobi_eig launch a projection (its one [2498, 16]
    bucket) and no other Jacobi kernel's; the device tally of full-sweep
    launches read once at the end. A second solve on the same model runs
    under ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing
    calls torch flags beyond the solver's own host waits stay under 0.1 an
    iteration (a host read of the sweep count would add one each)."""
    import warnings

    import torch
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems
    from cosmo_tpu_torch.ops import jacobi_eig as JE

    data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    settings = pt.Settings(decompose=True, accelerator=None, dtype=np.float64,
                           eps_abs=1e-5, eps_rel=1e-5, max_iter=20000,
                           eigh_backend="amortized")
    model = pt.Model(settings, device=device).set(*data)
    res, counts = counted_optimize(model)
    n_full = JE.full_sweep_count(device)
    info, t = model.last_solve, res.times
    err = abs(res.obj_val - REF_BANDED) / abs(REF_BANDED)
    launches = counts["jacobi_eig"]
    out = dict(status=res.status, iter=res.iter, obj=res.obj_val, rel_err=err,
               setup_s=t.setup_time, graph_s=t.graph_time, solve_s=info["iter_time"],
               iter_per_s=res.iter / info["iter_time"], launches=launches,
               full_sweep_launches=n_full, projections=info["projections"],
               syncs=info["syncs"], host_waits_per_iter=info["syncs"] / max(res.iter, 1),
               buckets=[(b.batch, b.side) for b in model._dev_cache["cones"].psd_buckets])
    log(f"[backends] 10b banded_sdp(10000, 8) float64 amortized: {res.status}, "
        f"{res.iter} iters, obj {res.obj_val:.12f} (rel err {err:.2e}, limit 1e-06), "
        f"setup {t.setup_time:.3f} s, solve {info['iter_time']:.3f} s, "
        f"{out['iter_per_s']:.1f} iter/s, PSD buckets {out['buckets']} "
        f"{info['bucket_backends']}, jacobi_eig launches {launches} ({n_full} full "
        f"sweeps, {n_full / max(launches, 1):.3f} of them) / projections "
        f"{info['projections']}, other kernels {counts}, solver host waits "
        f"{info['syncs']} ({out['host_waits_per_iter']:.4f} an iteration) [{smi}]")
    if res.status != "Solved" or not err <= 1e-6:
        raise AssertionError(f"10b: {res.status}, obj {res.obj_val}")
    if (info["bucket_backends"] != ("amortized",) or info["kkt_solver"] != "blockdiag"
            or not launches == info["projections"] > 0
            or counts["jacobi_proj"] or counts["jacobi_proj_rr"]):
        raise AssertionError(f"10b left its path: {info}, {counts}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res2 = model.optimize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    flagged = sum("synchroniz" in str(w.message) for w in caught)
    extra = (flagged - model.last_solve["syncs"]) / max(res2.iter, 1)
    out.update(sync_debug_iter=res2.iter, flagged_syncs=flagged,
               sync_debug_solver_syncs=model.last_solve["syncs"],
               flagged_beyond_solver_per_iter=extra)
    log(f"[backends] 10b under sync debug: {res2.status}, {res2.iter} iters, "
        f"torch-flagged synchronizing calls {flagged}, solver host waits "
        f"{model.last_solve['syncs']}: {extra:.4f} flagged an iteration beyond the "
        f"solver's (limit 0.1)")
    if res2.status != "Solved" or not extra < 0.1:
        raise AssertionError(f"10b sync debug: {res2.status}, {out}")
    return out


def phase_jacobi_mm(device, smi):
    """10c: block_sdp(512, 16, 512) at phase 4's plain float64 settings with
    eigh_backend="jacobi_mm" (the packed-rotation Jacobi as batched
    products, torch ops): Solved within 1e-6 of ``REF_OBJ``, no Jacobi
    kernel launched."""
    model = block_sdp_model(device, np.float64, eigh_backend="jacobi_mm")
    res, counts = counted_optimize(model)
    info = model.last_solve
    err = abs(res.obj_val - REF_OBJ) / abs(REF_OBJ)
    out = dict(status=res.status, iter=res.iter, obj=res.obj_val, rel_err=err,
               solve_s=info["iter_time"], iter_per_s=res.iter / info["iter_time"],
               projections=info["projections"], backends=info["bucket_backends"])
    log(f"[backends] 10c block_sdp(512,16,512) float64 jacobi_mm: {res.status}, "
        f"{res.iter} iters, obj {res.obj_val:.13f} (rel err {err:.2e}, limit 1e-06), "
        f"solve {info['iter_time']:.3f} s, {out['iter_per_s']:.2f} iter/s, PSD backend "
        f"{info['bucket_backends']}, kernel launches {counts} [{smi}]")
    if res.status != "Solved" or not err <= 1e-6:
        raise AssertionError(f"10c: {res.status}, obj {res.obj_val}")
    if info["bucket_backends"] != ("jacobi_mm",) or any(counts.values()):
        raise AssertionError(f"10c left its path: {info}, {counts}")
    return out


def phase_examples(device):
    """10d: every example of ``cosmo_tpu_torch/examples`` through its
    ``main("cuda")`` in float64, in this process; its own assertions
    decide. Logs the seconds of each. The objects of the earlier phases are
    frozen out of the garbage collector first: ``portfolio_backtest``
    asserts that a re-solve beats the first solve on the host clock (the
    first captures the scaling graph that the re-solves replay, tens of
    milliseconds), which a full collection over this process's heap could
    swamp."""
    import gc
    import importlib

    from cosmo_tpu_torch.examples import EXAMPLES

    seconds = {}
    gc.collect()
    gc.freeze()
    try:
        for name in EXAMPLES:
            t = time.perf_counter()
            importlib.import_module(f"cosmo_tpu_torch.examples.{name}").main(str(device))
            seconds[name] = time.perf_counter() - t
            log(f"[backends] 10d example {name}: ok in {seconds[name]:.2f} s")
    finally:
        gc.unfreeze()
    return seconds


def phase_backends(device, smi):
    """10a-10d."""
    out = {}
    for name, run in (("eig_kernel", lambda: phase_eig_kernel(device)),
                      ("amortized", lambda: phase_amortized(device, smi)),
                      ("jacobi_mm", lambda: phase_jacobi_mm(device, smi)),
                      ("examples", lambda: phase_examples(device))):
        t = time.perf_counter()
        out[name] = run()
        out[f"{name}_s"] = time.perf_counter() - t
    return out


def _digest(a) -> str:
    """A hash of an array's bits (the ranks' results compared without
    moving them)."""
    import hashlib

    a = np.ascontiguousarray(a)
    return hashlib.sha1(a.view(np.uint8)).hexdigest() + f":{a.dtype}{a.shape}"


def _mesh_solve(model, mesh, out_dir, label, rank, save):
    """One counted ``optimize(mesh=)`` on this rank; its result's digests
    and facts, and (``save``) x and s written to ``out_dir``."""
    from cosmo_tpu_torch.ops import exp_pow_proj as K
    from cosmo_tpu_torch.ops import jacobi_eig as JE
    from cosmo_tpu_torch.ops import jacobi_proj as J
    from cosmo_tpu_torch.ops import jacobi_proj_rr as R

    J.psd_project_pallas.launches = R.psd_project_rr.launches = 0
    K.project_exp.launches = K.project_pow.launches = 0
    JE.reset_counts()
    res = model.optimize(mesh=mesh)
    counts = {"jacobi_proj": J.psd_project_pallas.launches,
              "jacobi_proj_rr": R.psd_project_rr.launches,
              "jacobi_eig": sum(JE.psd_project_amortized.launches.values())}
    info, cones = model.last_solve, model._dev_cache["cones"]
    if save:
        for name in ("x", "s"):
            np.save(os.path.join(out_dir, f"{label}_{name}.npy"), getattr(res, name))
    return dict(
        status=res.status, iter=res.iter, obj=res.obj_val, iter_s=info["iter_time"],
        setup_s=res.times.setup_time, graph_s=res.times.graph_time,
        projections=info["projections"], collectives=info["collectives"],
        kkt_solver=info["kkt_solver"], counts=counts,
        digests={a: _digest(getattr(res, a)) for a in ("x", "y", "s")},
        buckets=[(b.batch, b.side, b.fastpath, b.backend or cones.eigh_backend,
                  b.split is not None) for b in cones.psd_buckets])


def _mesh_rank(rank, world, port, nccl_port, out_dir):
    """Phase 11's rank body (spawned): 11a and 11b on the gloo group of
    ``world`` ranks that share the card, then on rank 0 alone 11c on a
    one-rank NCCL group. Writes its results to ``out_dir/rank<r>.json``."""
    import datetime

    import torch.distributed as dist

    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems
    from cosmo_tpu_torch.parallel import make_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    out = {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timeout)
    mesh = make_mesh(world)
    P, q, A, b, sets, _ = problems.maxcut(10000, 4.0 / 10000, seed=0, sparse=True)
    model = pt.Model(pt.Settings(**MAXCUT10K_MESH)).set(P, q, A, b, sets)
    out["maxcut"] = _mesh_solve(model, mesh, out_dir, "maxcut", rank, rank == 0)
    del model, P, q, A, b, sets
    banded = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    model = pt.Model(pt.Settings(**BANDED_PLAIN)).set(*banded)
    out["banded"] = _mesh_solve(model, mesh, out_dir, "banded", rank, rank == 0)
    dist.destroy_process_group()
    if rank == 0:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{nccl_port}",
                                rank=0, world_size=1, timeout=timeout)
        model = pt.Model(pt.Settings(**dict(BANDED_PLAIN, max_iter=NCCL_ITERS)))
        out["nccl"] = _mesh_solve(model.set(*banded), make_mesh(1), out_dir, "nccl",
                                  rank, True)
        out["nccl"]["backend"] = dist.get_backend()
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def phase_mesh(device, smi, banded_single, banded_x):
    """Phase 11: ``Model.optimize(mesh=make_mesh())`` over torch.distributed.
    Runs the unsharded references here, then spawns ``MESH_RANKS`` gloo
    ranks on the card: (a) maxcut-10k at fixed work, x and s held to the
    unsharded run, every rank's side-8 share through ``jacobi_proj``, the
    [1, 896] colpad bucket matrix-row sharded; (b) the banded SDP Solved at
    ``REF_BANDED``, x within 1e-6 of phase 5's unsharded solution
    (``banded_x``), its iter/s beside phase 5's (``banded_single``); (c)
    the same problem for ``NCCL_ITERS`` iterations on a one-rank NCCL
    group, within 1e-9 relative of the unsharded run. Every rank's x, y and s have the
    same bits. A rank that fails fails the run."""
    import tempfile

    import torch.multiprocessing as mp

    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    # the unsharded references first, alone on the card
    P, q, A, b, sets, _ = problems.maxcut(10000, 4.0 / 10000, seed=0, sparse=True)
    maxcut_ref = pt.Model(pt.Settings(**MAXCUT10K_MESH), device=device).set(
        P, q, A, b, sets).optimize()
    del P, q, A, b, sets
    banded = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    nccl_ref = pt.Model(pt.Settings(**dict(BANDED_PLAIN, max_iter=NCCL_ITERS)),
                        device=device).set(*banded).optimize()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ctx = mp.start_processes(_mesh_rank, args=(MESH_RANKS, _free_port(), _free_port(),
                                               out_dir),
                             nprocs=MESH_RANKS, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + 2 * MESH_TIMEOUT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise AssertionError("phase 11: the mesh ranks did not finish")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    def load(label, name):
        return np.load(os.path.join(out_dir, f"{label}_{name}.npy"))

    def rel_max(a, ref):
        return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300))

    out = {}
    for case in ("maxcut", "banded"):
        digests = [r_[case]["digests"] for r_ in ranks]
        if any(d != digests[0] for d in digests):
            raise AssertionError(f"mesh {case}: the ranks' x, y, s differ: {digests}")
    # 11a: the north-star layout at full size, fixed work
    mc = ranks[0]["maxcut"]
    x_err = float(np.max(np.abs(load("maxcut", "x") - maxcut_ref.x)
                         - MESH_RTOL * np.abs(maxcut_ref.x)))
    s_err = float(np.max(np.abs(load("maxcut", "s") - maxcut_ref.s)
                         - MESH_RTOL * np.abs(maxcut_ref.s)))
    colpad = [bk for bk in mc["buckets"] if bk[1] == 896 and bk[2] == "colpad"]
    kernel = [bk for bk in mc["buckets"] if bk[3] == "pallas"]
    out["maxcut"] = dict(mc, x_excess=x_err, s_excess=s_err,
                         single_iter=maxcut_ref.iter,
                         collectives_per_iter=mc["collectives"] / max(mc["iter"], 1),
                         iter_per_s=mc["iter"] / mc["iter_s"],
                         ranks=[r_["maxcut"]["counts"] for r_ in ranks])
    log(f"[mesh] 11a maxcut-10000 float32 on {MESH_RANKS} gloo ranks sharing the card, "
        f"plain ADMM, {mc['iter']} iters (unsharded {maxcut_ref.iter}): x and s within "
        f"rtol {MESH_RTOL:.0e} + atol (excess over rtol: x {x_err:.2e}, s {s_err:.2e}; "
        f"limit {MESH_ATOL:.0e}); graph {mc['graph_s']:.2f} s, setup "
        f"{mc['setup_s']:.2f} s, solve {mc['iter_s']:.2f} s, "
        f"{out['maxcut']['iter_per_s']:.2f} iter/s, x digest {mc['digests']['x']}, "
        f"collectives an iteration "
        f"{out['maxcut']['collectives_per_iter']:.2f}; rank 0's PSD buckets (B, side, "
        f"layout, backend, matrix-row split) {mc['buckets']}; launches by rank "
        f"{out['maxcut']['ranks']} / projections {mc['projections']} [{smi}]")
    if not (x_err <= MESH_ATOL and s_err <= MESH_ATOL and mc["iter"] == maxcut_ref.iter):
        raise AssertionError(f"mesh maxcut: {out['maxcut']}")
    if not (colpad and all(bk[4] for bk in colpad) and len(kernel) == 1
            and kernel[0][:2] == [8540 // MESH_RANKS, 8] and not kernel[0][4]):
        raise AssertionError(f"mesh maxcut left its layout: {mc['buckets']}")
    for r_ in ranks:
        c = r_["maxcut"]["counts"]
        if not (c["jacobi_proj"] == r_["maxcut"]["projections"] > 0
                and c["jacobi_proj_rr"] == 0):
            raise AssertionError(f"mesh maxcut: launches {c} for "
                                 f"{r_['maxcut']['projections']} projections")
    # 11b: a full solve on the ranks
    bd = ranks[0]["banded"]
    err = abs(bd["obj"] - REF_BANDED) / abs(REF_BANDED)
    x_diff = float(np.max(np.abs(load("banded", "x") - banded_x)))
    ips = bd["iter"] / bd["iter_s"]
    out["banded"] = dict(bd, rel_err=err, x_diff=x_diff, iter_per_s=ips,
                         collectives_per_iter=bd["collectives"] / max(bd["iter"], 1),
                         phase5_iter=banded_single["iter"],
                         phase5_iter_per_s=banded_single["iter_per_s"])
    log(f"[mesh] 11b banded_sdp(10000, 8) float64 on {MESH_RANKS} gloo ranks: "
        f"{bd['status']}, {bd['iter']} iters, obj {bd['obj']:.12f} (rel err {err:.2e}, "
        f"limit 1e-06), x within {x_diff:.2e} of phase 5's unsharded solution (limit "
        f"1e-06); solve {bd['iter_s']:.2f} s, {ips:.1f} iter/s against "
        f"phase 5's {banded_single['iter']} iters at {banded_single['iter_per_s']:.1f} "
        f"iter/s; collectives an iteration {out['banded']['collectives_per_iter']:.2f}; "
        f"launches by rank {[r_['banded']['counts'] for r_ in ranks]} / projections "
        f"{bd['projections']} [{smi}]")
    if bd["status"] != "Solved" or not err <= 1e-6 or not x_diff <= 1e-6:
        raise AssertionError(f"mesh banded: {out['banded']}")
    if bd["kkt_solver"] != "blockdiag" or any(
            r_["banded"]["counts"]["jacobi_proj"] != bd["projections"] for r_ in ranks):
        raise AssertionError(f"mesh banded left its path: {out['banded']}")
    # 11c: NCCL
    nc = ranks[0]["nccl"]
    rel = rel_max(load("nccl", "x"), nccl_ref.x)
    out["nccl"] = dict(nc, x_rel=rel, single_iter=nccl_ref.iter,
                       collectives_per_iter=nc["collectives"] / max(nc["iter"], 1))
    log(f"[mesh] 11c banded on a one-rank {nc['backend']} group, {nc['iter']} iters "
        f"(unsharded {nccl_ref.iter}): x within {rel:.2e} relative (limit 1e-09), "
        f"collectives an iteration {out['nccl']['collectives_per_iter']:.2f}, "
        f"{nc['iter'] / nc['iter_s']:.1f} iter/s [{smi}]")
    if nc["backend"] != "nccl" or nc["iter"] != nccl_ref.iter or not rel <= 1e-9:
        raise AssertionError(f"mesh nccl: {out['nccl']}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory for chip_smoke.json")
    parser.add_argument("--seed", type=int, default=0, help="the portfolio data's seed")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this runs on a CUDA card")
        return 1
    import cosmo_tpu_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda")
    t0 = time.perf_counter()
    smi = phase_environment()
    build_s = phase_build()
    seconds = {"build": build_s}

    def timed(name, run):
        t = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t
        return out

    kernel_rows = timed("kernel", lambda: phase_kernel(device) + phase_cone_kernel(device))
    slice_out = timed("slice", lambda: phase_slice(device, smi))
    known = timed("known", lambda: phase_known_answers(device))
    plugins = timed("plugins", lambda: phase_plugins(device, smi))
    decomposed = timed("decomposed", lambda: phase_decomposed(device, smi))
    default = timed("default", lambda: phase_default(device, smi))
    maxcut = timed("maxcut", lambda: phase_maxcut(device, smi))
    cg = timed("cg", lambda: phase_cg(device, smi, args.seed))
    cones = timed("cones", lambda: phase_cones(device, smi, args.seed))
    backends = timed("backends", lambda: phase_backends(device, smi))
    banded_x = decomposed.pop("x")
    mesh = timed("mesh", lambda: phase_mesh(device, smi, decomposed["jacobi_proj_cold"],
                                            banded_x))
    seconds["total"] = time.perf_counter() - t0
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

    # each kernel at the shape of its path, with that path's launches:
    # jacobi_proj on the banded default path (B = 2498, k = 16, float32,
    # phase 6), on the maxcut-10k path (B = 8540, k = 8, float32, phase 7),
    # on the banded-CG path (B = 2498, k = 16, float32, phase 8a) and on a
    # mesh rank's share of maxcut-10k (B = 4270, k = 8, float32, phase 11a),
    # jacobi_proj_rr under COSMO_TPU_PALLAS_RR (B = 2498, k = 16, float64,
    # phase 5)
    kernels = []
    for name, replaces, dtype_name, B, k, path, launches in (
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32", 2498, 16,
             "banded_default", default["float32"]["launches"]),
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32", 8540, 8,
             "maxcut-10000", maxcut["maxcut-10000"]["launches"]),
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32", 2498, 16,
             "banded_cg", cg["banded_cg"]["launches"]),
            ("jacobi_proj_rr", "cosmo_tpu/ops/pallas_eigh.py:69", "float64", 2498, 16,
             "banded", decomposed["jacobi_proj_rr_cold"]["launches"]),
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32",
             8540 // MESH_RANKS, 8, f"mesh maxcut-10000, rank 0 of {MESH_RANKS}",
             mesh["maxcut"]["counts"]["jacobi_proj"])):
        row = next(r for r in kernel_rows if r["kernel"] == name
                   and r["dtype"] == dtype_name and r.get("k") == k and r.get("B") == B)
        kernels.append(dict(
            name=name,
            route="cuda",
            source=f"cosmo_tpu_torch/csrc/{name}.cu",
            replaces=replaces,
            launches=launches,
            max_abs_err=row["max_abs_err"],
            ms=row["ms"],
            device_ms=row["device_ms"],
            shape=dict(B=B, k=k, dtype=dtype_name),
            path=path,
            plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"],
            bound_by=row["bound_by"],
            library_ms=row["library_ms"],
        ))
    # the exp/pow kernel at the 9a path's N (its exp entry in float64, its
    # pow entry at alpha 0.5 in float64, launched on phase 4's pow cone)
    for name, alpha, launches in (
            ("exp_pow_proj/exp", None, cones["logistic"]["launches"]),
            ("exp_pow_proj/pow", 0.5, plugins["pow_launches"])):
        n = max(CONE_SIZES)
        row = next(r for r in kernel_rows if r["kernel"] == name and r["dtype"] == "float64"
                   and r.get("N") == n and r["alpha"] == alpha)
        kernels.append(dict(
            name=name, route="cuda", source="cosmo_tpu_torch/csrc/exp_pow_proj.cu",
            replaces=("cosmo_tpu/ops/exp_pow.py:133" if alpha is None
                      else "cosmo_tpu/ops/exp_pow.py:213"),
            launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
            device_ms=row["device_ms"], shape=dict(N=n, dtype="float64", alpha=alpha),
            path="logistic_a9a" if alpha is None else "known pow_cone",
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None))
    # the warm-started Jacobi kernel at the 10b path's shape (B = 2498, k =
    # 16, float64): one row at the warm sweeps with the path's warm
    # launches, one at the full sweeps with its full-sweep launches
    amortized = backends["amortized"]
    for sweeps, launches in (
            (WARM_SWEEPS, amortized["launches"] - amortized["full_sweep_launches"]),
            (SWEEPS, amortized["full_sweep_launches"])):
        row = next(r for r in backends["eig_kernel"] if r["dtype"] == "float64"
                   and r["k"] == 16 and r["B"] == 2498 and r["sweeps"] == sweeps)
        kernels.append(dict(
            name="jacobi_eig", route="cuda", source="cosmo_tpu_torch/csrc/jacobi_eig.cu",
            replaces="cosmo_tpu/ops/eigh.py:266", launches=launches,
            max_abs_err=row["max_abs_err"], ms=row["ms"], device_ms=row["device_ms"],
            shape=dict(B=2498, k=16, dtype="float64", sweeps=sweeps),
            path="banded_amortized", plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                           seconds=seconds, kernel=kernel_rows, slice=slice_out,
                           known=known, plugins=plugins, decomposed=decomposed,
                           default=default, maxcut=maxcut, cg=cg, cones=cones,
                           backends=backends, mesh=mesh, kernels=kernels),
                      f, indent=1, default=str)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
