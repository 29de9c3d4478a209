"""The exp-cone kernel against another checkout's, on one card.

    python -m cosmo_tpu_torch.profile_exp [--other DIR] [--logistic] [--lanes 1,7]

On each set of rows, :func:`cone_points` at N = 65,122 in float32 and
float64 (``chip_smoke.py`` phase 3's rows) and, with ``--logistic``, the
first, middle and last exp stacks of ``chip_smoke.py`` 9a's solve
(recorded by :func:`recorded_exp_stacks`), it prints for each kernel the
rows whose bits differ from the plain version's, ``launch_ms`` and
``device_ms``; for this checkout's kernel also the warp passes and lane
Newton steps of one launch of its counting build (``-DEXP_PROJ_PROFILE``,
:func:`profile_library`) and the lane efficiency, the plain version's
Newton lane steps over 32 times the warp passes, beside the
one-thread-a-row layout's (:func:`thread_layout_efficiency`, from the plain
version's per-row counts). With ``--logistic`` it also solves 9a in turns
(the other checkout's kernel, this one, this one with the three stacks
``chip_smoke.py`` keeps recorded, this one, the
other's, then this one with every stack recorded), each on a model of its
own after one warm-up solve, and prints each solve's iter/s, then each
kernel's device time summed over every projection of the last solve
(:func:`summed_ms`). With ``--other DIR`` (the root of another checkout,
for instance the parent commit unpacked with ``git archive``), that
checkout's exp kernel, from its own library, is timed in turns other,
this, this, other. With ``--lanes 1,7`` also counting builds of the
kernel with cones on 1 and on 7 lanes (:func:`profile_library`), timed
and counted beside it. The libraries build together, one ``nvcc`` each.
Needs CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .kernel_timing import _other_cuda_build, device_ms, launch_ms
from .ops import cuda_build
from .ops import exp_pow as E
from .ops import exp_pow_proj

SOURCE = cuda_build.CSRC / "exp_pow_proj.cu"
N = 65122          # the exp cones of chip_smoke.py's logistic path (9a)
MAX_ITER = 100     # ExponentialCone's default
# the middle of 9a's 393 projections (in every run on an H100 so far),
# the stack that chip_smoke.py's recorder keeps beside the first and last
PATH_MIDDLE = 196


def cone_points(n, dtype, device, seed):
    """Rows covering the four cases of both projections (a Gaussian times
    a scale from e^-3 to e^3 a row, every 20th row with |z| = 1e-9), half
    dual, tolerances 1e-8 and 1e-6, made from ``seed``."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-3, 3, (n, 1)))
    V[::20, 2] = 1e-9 * np.sign(V[::20, 2])
    to = dict(dtype=dtype, device=device)
    return (torch.as_tensor(V, **to), torch.as_tensor(rng.random(n) < 0.5, device=device),
            torch.as_tensor(np.where(rng.random(n) < 0.5, 1e-8, 1e-6), **to))


def profile_library(lanes=None) -> ctypes.CDLL:
    """The exp/pow source built with ``EXP_PROJ_PROFILE``: its exp
    launches also count their warp passes and lane Newton steps, which
    ``exp_proj_profile(unsigned long long* out)`` reads and clears. With
    ``lanes``, a copy of the source whose cones run on that many lanes
    (its ``kLanes``), to measure that layout against the shipped one."""
    name = "exp_profile" if lanes is None else f"exp_profile_l{lanes}"
    so = cuda_build.library_path([SOURCE], name)
    if not so.is_file():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        source = SOURCE
        if lanes is not None:
            text, count = re.subn(r"constexpr int kLanes = \d+;",
                                  f"constexpr int kLanes = {lanes};", SOURCE.read_text())
            if count != 1:
                raise RuntimeError(f"{SOURCE.name}: no single kLanes to set")
            source = so.with_suffix(".cu")
            source.write_text(text)
        tmp = so.with_suffix(".tmp")
        subprocess.run([cuda_build._nvcc(), *cuda_build.ARCH, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-DEXP_PROJ_PROFILE",
                        f"-I{cuda_build.CSRC}", "-o", str(tmp), str(source)],
                       check=True)
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "f64"):
        getattr(lib, f"exp_proj_{t}").argtypes = [p, p, p, p, i, i, p]
        getattr(lib, f"exp_proj_{t}").restype = i
    lib.exp_proj_profile.argtypes = [p]
    lib.exp_proj_profile.restype = i
    return lib


def launch(lib, V, dual, tol, max_iter=MAX_ITER):
    """One launch of ``lib``'s exp entry on the current stream."""
    out = torch.empty_like(V)
    flags = dual.to(torch.uint8)
    fn = lib.exp_proj_f32 if V.dtype == torch.float32 else lib.exp_proj_f64
    err = fn(V.data_ptr(), flags.data_ptr(), tol.data_ptr(),
             out.data_ptr(), V.shape[0], int(max_iter),
             torch.cuda.current_stream(V.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exp kernel launch failed: CUDA error {err}")
    return out


def counted_launch(lib, V, dual, tol, max_iter=MAX_ITER):
    """One launch of a profiled build: its rows, warp passes and lane
    Newton steps."""
    counts = (ctypes.c_ulonglong * 2)()
    lib.exp_proj_profile(counts)
    out = launch(lib, V, dual, tol, max_iter)
    if lib.exp_proj_profile(counts) != 0:
        raise RuntimeError("exp_proj_profile failed")
    return out, int(counts[0]), int(counts[1])


def differing_rows(got, ref) -> int:
    """Rows of ``got`` with an entry whose bits differ from ``ref``'s (a
    NaN in both counts as the same)."""
    bits = torch.int32 if got.dtype == torch.float32 else torch.int64
    same = (got.view(bits) == ref.view(bits)) | (torch.isnan(got) & torch.isnan(ref))
    return int((~same.all(dim=1)).sum().item())


def case_mix(V, dual) -> list:
    """Rows in each case of ``_project_exp_one`` (1: in the cone, 2: in
    the polar, 3: the closed form, 4: the bisection)."""
    U = torch.where(dual[:, None], -V, V)
    c1 = E.exp_in_cone(U, 0.0)
    c2 = E.exp_in_dual(-U, 0.0) & ~c1
    c3 = (U[:, 0] < 0) & (U[:, 1] < 0) & ~c1 & ~c2
    c4 = ~(c1 | c2 | c3)
    return [int(c.sum().item()) for c in (c1, c2, c3, c4)]


def thread_layout_efficiency(row_newton) -> float:
    """Newton lane steps over 32 times the warp passes of one thread a
    row, blocks of 32 rows in order: a warp steps until its slowest lane
    is done (a lower bound of its passes: it also diverges between loops)."""
    steps = row_newton.to(torch.float64)
    pad = (-steps.numel()) % 32
    warps = torch.nn.functional.pad(steps, (0, pad)).view(-1, 32).amax(dim=1)
    return lane_efficiency(float(steps.sum()), float(warps.sum()))


def lane_efficiency(newton, passes) -> float:
    """Newton lane steps over 32 times the warp passes (0 without work)."""
    return newton / (32 * passes) if passes else 0.0


@contextlib.contextmanager
def recorded_exp_stacks(keep=None):
    """Wrap ``exp_pow_proj.project_exp``, the name the solver's projection
    calls, for the body of the ``with``; yields the record: ``n``, the
    calls, and ``V``, call number -> its rows, of every call (``keep``
    None) or of the calls numbered in ``keep`` and the last one. The rows
    are kept by reference: the projection gathers them afresh for each
    call, so the record copies nothing and adds no device work
    (:func:`recorded_stack` checks that nothing wrote them since); every
    stack kept holds its memory, which grows the allocator's pool when all
    are. Also the call's ``is_dual``, ``tol`` and ``max_iter`` (the same
    every call on one model). The launch count goes on in the wrapper and
    is handed back to the wrapped function at the end."""
    original = exp_pow_proj.project_exp
    record = dict(n=0, V={}, versions={})

    def project_exp(V, is_dual, tol, max_iter=100):
        k = record["n"]
        record["n"] = k + 1
        if keep is not None and k - 1 not in keep:
            record["V"].pop(k - 1, None)
        record["V"][k] = V
        record["versions"][k] = V._version
        record.update(is_dual=is_dual, tol=tol, max_iter=max_iter)
        return original(V, is_dual, tol, max_iter)

    project_exp.launches = original.launches
    exp_pow_proj.project_exp = project_exp
    try:
        yield record
    finally:
        original.launches = project_exp.launches
        exp_pow_proj.project_exp = original


def recorded_stack(record, k):
    """Stack ``k`` of a :func:`recorded_exp_stacks` record (the last: ``k =
    record["n"] - 1``); raises if it was written after its call."""
    V = record["V"][k]
    if V._version != record["versions"][k]:
        raise RuntimeError(f"exp stack {k} was written after its projection")
    return V


@contextlib.contextmanager
def exp_library(lib):
    """``exp_pow_proj`` launches ``lib``'s kernels (another checkout's
    library, say) for the body of the ``with``."""
    original = cuda_build.exp_pow_library
    cuda_build.exp_pow_library = lambda: lib
    try:
        yield
    finally:
        cuda_build.exp_pow_library = original


def logistic_model(device, seed=0):
    """A function that makes ``chip_smoke.py`` 9a's model (LIBSVM's a9a in
    shape: 32,561 samples, 123 features, 14 set a sample, lam = 0.5, made
    from ``seed``; float64, eps 1e-5), with settings ``overrides``."""
    import cosmo_tpu_torch as pt

    from . import problems

    P, q, A, b, sets, _ = problems.logistic_regression(32561, 123, 14, lam=0.5, seed=seed)

    def make(**overrides):
        settings = pt.Settings(**dict(dict(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64),
                                      **overrides))
        return pt.Model(settings, device=device).set(P, q, A, b, sets)

    return make


def solve_rate(model):
    """One solve: its status, iterations and iter/s (iterations over the
    iteration loop's time, as ``chip_smoke.py`` reports them)."""
    res = model.optimize()
    return res.status, res.iter, res.iter / model.last_solve["iter_time"]


def summed_ms(lib, stacks):
    """Device ms of one launch of ``lib``'s exp kernel on each stack of
    ``stacks`` (:func:`recorded_exp_stacks`), summed: CUDA events around each
    launch, the launches back to back, after one warm-up launch."""
    dual, tol, it = stacks["is_dual"], stacks["tol"], stacks["max_iter"]
    launch(lib, stacks["V"][0], dual, tol, it)
    events = []
    for V in stacks["V"].values():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(lib, V, dual, tol, it)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events)


def plain_work(V, dual, tol, max_iter=MAX_ITER):
    """The plain version's rows and per-row work counts on these rows."""
    stats = {}
    ref = E.project_exp_plain(V, dual, tol, max_iter, stats=stats, per_row=True)
    return ref, stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="root of another checkout")
    parser.add_argument("--logistic", action="store_true",
                        help="also solve chip_smoke.py 9a and time its own exp stacks")
    parser.add_argument("--lanes", default="",
                        help="other lanes a cone to measure, comma-separated (1,7)")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_exp needs a CUDA device")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    builds = {"this": cuda_build.exp_pow_library, "counting": profile_library}
    lanes = [int(n) for n in args.lanes.split(",") if n]
    builds.update({f"lanes {n}": lambda n=n: profile_library(n) for n in lanes})
    if args.other:
        builds["other"] = _other_cuda_build(Path(args.other).resolve()).exp_pow_library
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda build: build(), builds.values())))
    counting = libs.pop("counting")
    variants = {f"lanes {n}": libs.pop(f"lanes {n}") for n in lanes}
    sets = []
    for dtype in (torch.float32, torch.float64):
        sets.append((f"cone_points({N}) {str(dtype)[6:]}",
                     cone_points(N, dtype, device, seed=N)))
    order = ["other", "this", "this", "other"] if args.other else ["this", "this"]
    if args.logistic:
        make = logistic_model(device)
        solve_rate(make(max_iter=25))  # warm-up
        # chip_smoke.py's recorder keeps the first and a middle stack and
        # the last; "every stack" keeps all of them, for the sums below
        turns = (["other", "this", "three stacks", "this", "other", "every stack"]
                 if args.other else ["this", "three stacks", "this", "every stack"])
        for turn in turns:
            with exp_library(libs["other" if turn == "other" else "this"]):
                if "stack" in turn:
                    keep = None if turn == "every stack" else (0, PATH_MIDDLE)
                    with recorded_exp_stacks(keep) as stacks:
                        status, iters, ips = solve_rate(make())
                else:
                    status, iters, ips = solve_rate(make())
            print(f"9a solve, {turn}: {status}, {iters} iterations, {ips:.2f} iter/s",
                  flush=True)
        n_proj = stacks["n"]
        for tree in order:
            print(f"9a's {n_proj} projections, device ms summed: {tree} "
                  f"{summed_ms(libs[tree], stacks):.2f}", flush=True)
        for tree, lib in variants.items():
            print(f"9a's {n_proj} projections, device ms summed: {tree} "
                  f"{summed_ms(lib, stacks):.2f}", flush=True)
        for name, k in (("first", 0), ("middle", n_proj // 2), ("last", n_proj - 1)):
            sets.append((f"9a projection {k} of {n_proj} ({name})",
                         (recorded_stack(stacks, k), stacks["is_dual"], stacks["tol"])))
    for label, (V, dual, tol) in sets:
        ref, stats = plain_work(V, dual, tol)
        print(f"{label}: cases {case_mix(V, dual)}, evaluations {stats.get('evals', 0)}, "
              f"Newton lane steps {stats.get('newton', 0)}, one thread a row: lane efficiency "
              f"{thread_layout_efficiency(stats['row_newton']):.4f}")
        times = {}
        for tree in order:
            fn = lambda: launch(libs[tree], V, dual, tol)  # noqa: E731
            times.setdefault(tree, []).append((launch_ms(fn, args.reps),
                                               device_ms(fn, max(1, args.reps // 4))))
        for tree, pairs in times.items():
            diff = differing_rows(launch(libs[tree], V, dual, tol), ref)
            print(f"  {tree}: rows differing {diff}; launch_ms "
                  f"{', '.join(f'{a:.4f}' for a, _ in pairs)}; device_ms "
                  f"{', '.join(f'{b:.4f}' for _, b in pairs)}")
        for tree, lib in {"this, counted": counting, **variants}.items():
            out, passes, steps = counted_launch(lib, V, dual, tol)
            fn = lambda: launch(lib, V, dual, tol)  # noqa: E731
            times = ("" if lib is counting else f"launch_ms {launch_ms(fn, args.reps):.4f}, "
                     f"device_ms {device_ms(fn, max(1, args.reps // 4)):.4f}; ")
            print(f"  {tree}: rows differing {differing_rows(out, ref)}; {times}warp passes "
                  f"{passes}, lane steps {steps}, lane efficiency "
                  f"{lane_efficiency(stats.get('newton', 0), passes):.4f}", flush=True)


if __name__ == "__main__":
    main()
