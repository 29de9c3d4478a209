#!/usr/bin/env python3
"""Smoke run of cosmo_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, in order; any failure ends the run with a non-zero exit code:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions;
2. build: compiles ``cosmo_tpu_torch/csrc/jacobi_proj.cu`` with nvcc for
   sm_90a (the ptxas report is printed);
3. kernel: holds the Jacobi projection kernel against its plain PyTorch
   version on the card (float32 and float64, k in {8, 16, 32, 48}, B in
   {1, 512, 8540}) and times kernel, plain version and the
   ``torch.linalg.eigh`` yardstick with CUDA events;
4. slice: solves ``problems.block_sdp(512, 16, 512, seed=0)`` with CSR A
   through ``Model.optimize`` on the card with plain ADMM, in float64 and
   float32 (a first solve, then a second on the same model), against the
   known objective, and checks that every projection of each solve went
   through the kernel; then the four known answers in float64.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result. With ``--out DIR`` the details also go to
``DIR/chip_smoke.json``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REF_OBJ = -0.5062352079829      # cosmo_tpu, CPU f64, eps 1e-5 (Solved)
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


def phase_build():
    from cosmo_tpu_torch.ops import jacobi_proj as J

    t0 = time.perf_counter()
    so = J.build()
    seconds = time.perf_counter() - t0
    log(f"[build] {so.name} in {seconds:.2f} s")
    report = so.with_suffix(".log")
    if report.is_file():
        log(report.read_text().strip())
    return seconds


def _stack(B, k, dtype, device, seed):
    import torch

    G = np.random.default_rng(seed).standard_normal((B, k, k))
    return torch.as_tensor((G + G.swapaxes(1, 2)) / 2, dtype=dtype, device=device)


def time_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    import torch

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


def phase_kernel(device, ks=(8, 16, 32, 48), Bs=(1, 512, 8540),
                 dtypes=("float32", "float64"), reps=20):
    """Kernel vs plain version at every shape; timings at each shape."""
    import torch
    from cosmo_tpu_torch.ops import eigh as E
    from cosmo_tpu_torch.ops import jacobi_proj as J

    rows = []
    for dtype_name in dtypes:
        dtype = getattr(torch, dtype_name)
        for k in ks:
            for B in Bs:
                X = _stack(B, k, dtype, device, seed=1000 * k + B)
                got = J.jacobi_proj_cuda(X, SWEEPS)      # uncounted launch
                torch.cuda.synchronize()
                ref = J.psd_project_jacobi_plain(X, SWEEPS)
                err = (got - ref).abs().max().item()
                scale = X.abs().max().item()
                ok = bool(np.isfinite(err)) and err <= TOL[dtype_name] * scale
                big = B * k * k > 512 * 16 * 16 * 8
                row = dict(
                    dtype=dtype_name, k=k, B=B, max_abs_err=err,
                    max_abs_x=scale, tol_rel=TOL[dtype_name], ok=ok,
                    ms=time_ms(lambda: J.jacobi_proj_cuda(X, SWEEPS), reps),
                    plain_ms=time_ms(lambda: J.psd_project_jacobi_plain(X, SWEEPS),
                                     2 if big else 5),
                    library_ms=time_ms(lambda: E.psd_project_eigh(X), 3 if big else reps),
                )
                row["bound_ms"], row["bound_by"] = jacobi_bound_ms(B, k, dtype_name)
                rows.append(row)
                log(f"[kernel] {dtype_name} k={k:2d} B={B:5d} err={err:.3e} "
                    f"(tol {TOL[dtype_name]:.0e}*{scale:.2f}) ms={row['ms']:.4f} "
                    f"plain={row['plain_ms']:.3f} eigh={row['library_ms']:.3f} "
                    f"bound={row['bound_ms']:.5f} ({row['bound_by']}) "
                    f"{'ok' if ok else 'FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
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


def counted_optimize(model):
    """model.optimize() with the kernel's launch count set to 0 just
    before and read just after; returns (result, launches)."""
    from cosmo_tpu_torch.ops import jacobi_proj as J

    J.psd_project_pallas.launches = 0
    res = model.optimize()
    return res, J.psd_project_pallas.launches


def phase_slice(device, smi):
    """The main path at full size, f64 then f32 (the card's default). Each
    model solves twice: the first solve also pays the one-time CUDA
    library set-up, the second is the steady state; both are checked."""
    out = {}
    for dtype, rel in ((np.float64, 1e-6), (None, 1e-4)):
        name = "float64" if dtype is not None else "float32"
        model = block_sdp_model(device, dtype)
        for run in ("cold", "warm"):
            res, launches = counted_optimize(model)
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
            if not launches == info["projections"] > 0:
                raise AssertionError(f"block_sdp {name}: {launches} kernel launches for "
                                     f"{info['projections']} projections")
            out[f"{name}_{run}"] = dict(
                status=res.status, iter=res.iter, obj=res.obj_val, rel_err=err,
                setup_s=res.times.setup_time, solve_s=info["iter_time"],
                iter_per_s=ips, launches=launches, projections=info["projections"])
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="directory for chip_smoke.json")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this runs on a CUDA card")
        return 1
    import cosmo_tpu_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda")
    smi = phase_environment()
    build_s = phase_build()
    kernel_rows = phase_kernel(device)
    slice_out = phase_slice(device, smi)
    known = phase_known_answers(device)

    main_row = next(r for r in kernel_rows
                    if r["dtype"] == "float32" and r["k"] == 16 and r["B"] == 512)
    kernels = [dict(
        name="jacobi_proj",
        route="cuda",
        source="cosmo_tpu_torch/csrc/jacobi_proj.cu",
        replaces="cosmo_tpu/ops/pallas_eigh.py:132",
        launches=slice_out["float32_warm"]["launches"],
        max_abs_err=main_row["max_abs_err"],
        ms=main_row["ms"],
        plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"],
        library_ms=main_row["library_ms"],
    )]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
                           build_s=build_s, kernel=kernel_rows, slice=slice_out,
                           known=known, kernels=kernels), f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
