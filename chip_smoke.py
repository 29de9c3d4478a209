#!/usr/bin/env python3
"""Smoke run of cosmo_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out DIR] [--seed N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: compiles both kernels' libraries with nvcc for sm_90a, one nvcc
   per source, all started together: the Jacobi kernels' from
   ``cosmo_tpu_torch/csrc/jacobi_proj.cu``, ``jacobi_proj_rr.cu`` and
   ``jacobi_smem.cu``, the exp/pow cone projection's from
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
   gamma = 1 problem through ``solver.solve_chunked`` in chunks of 100
   iterations against the uninterrupted solve (the same status, objective
   within 1e-5); (d) the re-solve with ``verbose_timing``, its phase
   timers finite, positive where the solve ran the phase;
9. cones: (a) the a9a-shaped logistic regression (65,122 exponential
   cones, float64, defaults, eps 1e-5) against ``logistic_optimum``, the
   exp kernel on every projection; (b) ``block_sdp(8, 256, 256)`` with
   mixed precision in float32 against ``REF_BLOCK8X256``, its loose phase
   ending, and the loose phase's iter/s against full float32 at fixed
   work; (c) 2,048 3-qubit state estimates through the complex PSD cone
   in float64 and float32 against their closed form, the [2048, 16]
   bucket through ``jacobi_proj``.

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


# the register body's instantiations: even k in 4..16, f32/f64, two schedules
REGISTER_BODIES = 2 * 7 * 2


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
# batch), checked beside the sweep
MAXCUT_SHAPES = ((8, 1729), (8, 8540))
# the shapes of the kernels line (the banded paths, maxcut-10k), timed
TIMED_SHAPES = ((16, 2498), (8, 8540))


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


def block_sdp_model(device, dtype, n_blocks=512, side=16, n=512, seed=0):
    """block_sdp with CSR A set on a Model with plain ADMM, eps 1e-5."""
    import scipy.sparse as sp
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import problems

    P, q, A, b, sets = problems.block_sdp(n_blocks=n_blocks, side=side, n=n, seed=seed)
    model = pt.Model(pt.Settings(accelerator=None, decompose=False, eps_abs=1e-5,
                                 eps_rel=1e-5, dtype=dtype), device=device)
    return model.set(P, q, sp.csr_matrix(A), b, sets)


def counted_optimize(model, on_iter=None):
    """model.optimize(on_iter=...) with every kernel's launch count set to
    0 just before and read just after; returns (result, {kernel:
    launches})."""
    from cosmo_tpu_torch.ops import exp_pow_proj as K
    from cosmo_tpu_torch.ops import jacobi_proj as J
    from cosmo_tpu_torch.ops import jacobi_proj_rr as R

    J.psd_project_pallas.launches = R.psd_project_rr.launches = 0
    K.project_exp.launches = K.project_pow.launches = 0
    res = model.optimize(on_iter=on_iter)
    return res, {"jacobi_proj": J.psd_project_pallas.launches,
                 "jacobi_proj_rr": R.psd_project_rr.launches,
                 "exp_pow_proj/exp": K.project_exp.launches,
                 "exp_pow_proj/pow": K.project_pow.launches}


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
    analysis, copies) and then warm (the same model: every cache hits)."""
    import cosmo_tpu_torch as pt
    from cosmo_tpu_torch import native, problems

    t0 = time.perf_counter()
    data = problems.banded_sdp(10000, 8, seed=0, sparse=True)[:5]
    log(f"[decomposed] banded_sdp(10000, 8) generated in "
        f"{time.perf_counter() - t0:.2f} s")
    settings = pt.Settings(decompose=True, accelerator=None, dtype=np.float64,
                           eps_abs=1e-5, eps_rel=1e-5, max_iter=20000)
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

    # (c) the same problem in chunks of 100 iterations through the carry
    dev = model._dev_cache
    m, n = model.model_size
    static, dyn = split_settings(model._resolved_settings, m, n, dev["qd"].dtype,
                                 refine_hint=refine_hint(sets), device=device)
    t1 = time.perf_counter()
    chunked = solver_mod.solve_chunked(dev["Pd"], dev["Ad"], dev["qd"], dev["bd"],
                                       dev["cones"], dev["x0"], dev["s0"], dev["mu0"],
                                       dyn, static, chunk=100)
    chunk_s = time.perf_counter() - t1
    rel = abs(chunked["cost"] - cold.obj_val) / abs(cold.obj_val)
    same = bool(np.array_equal(chunked["x"], cold.x))
    out["chunked"] = dict(status=chunked["status"], iter=chunked["iter"],
                          obj=chunked["cost"], rel_to_uninterrupted=rel, solve_s=chunk_s,
                          kkt_solver_iters=chunked["kkt_solver_iters"], x_bit_identical=same)
    log(f"[cg] portfolio gamma=1 in chunks of 100: status {chunked['status']}, "
        f"{chunked['iter']} iters (uninterrupted {cold.iter - cold.safeguarding_iter}), CG "
        f"steps {chunked['kkt_solver_iters']} (uninterrupted "
        f"{runs['gamma=1 cold']['kkt_solver_iters']}), obj {chunked['cost']:.12f}, rel "
        f"{rel:.2e} of the uninterrupted (limit 1e-05), x bit-identical {same}, "
        f"{chunk_s:.3f} s")
    if chunked["status"] != 1 or not rel <= 1e-5:
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
    seconds["total"] = time.perf_counter() - t0
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

    # each kernel at the shape of its path, with that path's launches:
    # jacobi_proj on the banded default path (B = 2498, k = 16, float32,
    # phase 6), on the maxcut-10k path (B = 8540, k = 8, float32, phase 7)
    # and on the banded-CG path (B = 2498, k = 16, float32, phase 8a),
    # jacobi_proj_rr under COSMO_TPU_PALLAS_RR (B = 2498, k = 16, float64,
    # phase 5's warm solve)
    kernels = []
    for name, replaces, dtype_name, B, k, path, launches in (
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32", 2498, 16,
             "banded_default", default["float32"]["launches"]),
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32", 8540, 8,
             "maxcut-10000", maxcut["maxcut-10000"]["launches"]),
            ("jacobi_proj", "cosmo_tpu/ops/pallas_eigh.py:132", "float32", 2498, 16,
             "banded_cg", cg["banded_cg"]["launches"]),
            ("jacobi_proj_rr", "cosmo_tpu/ops/pallas_eigh.py:69", "float64", 2498, 16,
             "banded", decomposed["jacobi_proj_rr_warm"]["launches"])):
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
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                           seconds=seconds, kernel=kernel_rows, slice=slice_out,
                           known=known, plugins=plugins, decomposed=decomposed,
                           default=default, maxcut=maxcut, cg=cg, cones=cones,
                           kernels=kernels),
                      f, indent=1, default=str)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
