"""The exp- and pow-cone kernels against another checkout's, on one card.

    python -m cosmo_tpu_torch.profile_exp [--other DIR] [--logistic] [--lanes 1,7]
    python -m cosmo_tpu_torch.profile_exp --pow [--other DIR] [--pnorm]

On each set of rows, :func:`cone_points` at N = 65,122 in float32 and
float64 (``chip_smoke.py`` phase 3's rows) and, with ``--logistic``, the
first, middle and last exp stacks of ``chip_smoke.py`` 9a's solve
(recorded by :func:`recorded_stacks`), it prints for each kernel the
rows whose bits differ from the plain version's, ``launch_ms`` and
``device_ms``; for this checkout's kernel also the warp passes and lane
Newton steps of one launch of its counting build (``-DEXP_PROJ_PROFILE``,
:func:`profile_library`) and the lane efficiency, the plain version's
Newton lane steps over 32 times the warp passes, beside the
one-thread-a-row layout's (:func:`thread_layout_efficiency`, from the plain
version's per-row counts). With ``--logistic`` it also solves 9a in turns
(the other checkout's kernel, this one, this one with the three stacks
``chip_smoke.py`` keeps recorded, this one, the other's, then this one
with every stack recorded), each on a model of its own after one warm-up
solve, and prints each solve's iter/s, then each kernel's time summed over
every projection of the last solve (:func:`summed_ms`, torch.profiler's
kernel durations). With ``--other DIR`` (the root of another checkout, for
instance the parent commit unpacked with ``git archive``), that checkout's
exp kernel, from its own library, is timed in turns other, this, this,
other. With ``--lanes 1,7`` also counting builds of the kernel with cones
on 1 and on 7 lanes (:func:`profile_library`), timed and counted beside
it.

``--pow`` does the same for the pow kernel (:func:`main_pow`), one
thread a row: phase 3's rows at alpha 0.3, 0.5 and 0.8, with ``--pnorm``
also 9d (l1.5 regression, 32,561 power cones) solved in turns for its
iter/s, the first, middle and last stacks of its solve, and the kernel time
summed over all of its projections (:func:`summed_ms`); each row set also
against the other kernel's bits, with its case mix, Newton steps and one
thread a row's lane efficiency. It ends with both trees' wrappers timed
(:func:`wrapper_rows`: the host's part of a call and the device operations
a call runs). The libraries build together, one ``nvcc`` each. Needs CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
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
POW_MAX_ITER = 20  # PowerCone's
# 9a's settings; 9d's (chip_smoke.py's l1.5 regression: 32,561 samples, 123
# features, 14 set a sample, p = 1.5) with more iterations than the default
# 5,000 and a time limit
LOGISTIC_SETTINGS = dict(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64)
PNORM_SHAPE = (32561, 123, 14, 1.5)
PNORM_SETTINGS = dict(LOGISTIC_SETTINGS, max_iter=30000, time_limit=300.0)
# the middle of 9a's 393 projections (in every run on an H100 so far),
# the stack that chip_smoke.py's recorder keeps beside the first and last
PATH_MIDDLE = 196
# the middle of 9d's 937 projections (in every run on an H100 so far)
PNORM_MIDDLE = 468


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


def launch(lib, V, dual, tol, max_iter=MAX_ITER, alpha=None):
    """One launch of ``lib``'s exp entry (with ``alpha``, its pow entry) on
    the current stream."""
    out = torch.empty_like(V)
    flags = dual.to(torch.uint8)
    sfx = "f32" if V.dtype == torch.float32 else "f64"
    rows = [] if alpha is None else [alpha.data_ptr()]
    fn = getattr(lib, f"{'exp' if alpha is None else 'pow'}_proj_{sfx}")
    err = fn(V.data_ptr(), *rows, flags.data_ptr(), tol.data_ptr(), out.data_ptr(),
             V.shape[0], int(max_iter), torch.cuda.current_stream(V.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exp/pow kernel launch failed: CUDA error {err}")
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


def case_mix(V, dual, alpha=None, tol=None) -> list:
    """Rows in each case of ``_project_exp_one`` (1: in the cone, 2: in
    the polar, 3: the closed form, 4: the bisection), or with ``alpha`` and
    ``tol`` of ``_project_pow_one`` (3: |z| <= tol, 4: the Newton)."""
    U = torch.where(dual[:, None], -V, V)
    if alpha is None:
        c1 = E.exp_in_cone(U, 0.0)
        c2 = E.exp_in_dual(-U, 0.0) & ~c1
        c3 = (U[:, 0] < 0) & (U[:, 1] < 0) & ~c1 & ~c2
    else:
        c1 = E.pow_in_cone(U, alpha, 0.0)
        c2 = E.pow_in_dual(-U, alpha, 0.0) & ~c1
        c3 = (U[:, 2].abs() <= tol) & ~c1 & ~c2
    c4 = ~(c1 | c2 | c3)
    return [int(c.sum().item()) for c in (c1, c2, c3, c4)]


def thread_layout_passes(row_newton) -> int:
    """The warp passes of one thread a row, blocks of 32 rows in order: a
    warp steps until its slowest lane is done (a lower bound of its passes:
    it also diverges between loops)."""
    steps = row_newton.to(torch.float64)
    pad = (-steps.numel()) % 32
    return int(torch.nn.functional.pad(steps, (0, pad)).view(-1, 32).amax(dim=1).sum())


def thread_layout_efficiency(row_newton) -> float:
    """Newton lane steps over 32 times the warp passes of one thread a row
    (:func:`thread_layout_passes`)."""
    return lane_efficiency(float(row_newton.sum()), float(thread_layout_passes(row_newton)))


def lane_efficiency(newton, passes) -> float:
    """Newton lane steps over 32 times the warp passes (0 without work)."""
    return newton / (32 * passes) if passes else 0.0


@contextlib.contextmanager
def recorded_stacks(family="exp", keep=None):
    """Wrap ``exp_pow_proj.project_exp`` (``project_pow``: ``family``
    "pow"), the name the solver's projection calls, for the body of the
    ``with``; yields the record: ``n``, the calls, and ``V``, call number
    -> its rows, of every call (``keep`` None) or of the calls numbered in
    ``keep`` and the last one, and ``sizes``, the rows of every call. The
    rows are kept by reference: the projection gathers them afresh for each
    call, so the record copies nothing and adds no device work
    (:func:`recorded_stack` checks that nothing wrote them since); every
    stack kept holds its memory, which grows the allocator's pool when all
    are. Also the call's ``is_dual``,
    ``tol``, ``max_iter`` and (pow) ``alpha``, the same every call on one
    model. The launch count goes on in the wrapper and is handed back to
    the wrapped function at the end."""
    name = f"project_{family}"
    original = getattr(exp_pow_proj, name)
    record = dict(n=0, V={}, versions={}, alpha=None, sizes=set())

    def keep_call(V, **args):
        k = record["n"]
        record["n"] = k + 1
        if keep is not None and k - 1 not in keep:
            record["V"].pop(k - 1, None)
        record["V"][k] = V
        record["versions"][k] = V._version
        record["sizes"].add(V.shape[0])
        record.update(args)

    def project_exp(V, is_dual, tol, max_iter=100):
        keep_call(V, is_dual=is_dual, tol=tol, max_iter=max_iter)
        return original(V, is_dual, tol, max_iter)

    def project_pow(V, alpha, is_dual, tol, max_iter=20):
        keep_call(V, alpha=alpha, is_dual=is_dual, tol=tol, max_iter=max_iter)
        return original(V, alpha, is_dual, tol, max_iter)

    wrapper = project_exp if family == "exp" else project_pow
    wrapper.launches = original.launches
    setattr(exp_pow_proj, name, wrapper)
    try:
        yield record
    finally:
        original.launches = wrapper.launches
        setattr(exp_pow_proj, name, original)


def recorded_stack(record, k):
    """Stack ``k`` of a :func:`recorded_stacks` record (the last: ``k =
    record["n"] - 1``); raises if it was written after its call."""
    V = record["V"][k]
    if V._version != record["versions"][k]:
        raise RuntimeError(f"stack {k} was written after its projection")
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
    from . import problems

    P, q, A, b, sets, _ = problems.logistic_regression(32561, 123, 14, lam=0.5, seed=seed)
    return _model(device, (P, q, A, b, sets), LOGISTIC_SETTINGS)


def pnorm_model(device, seed=0):
    """The same for ``chip_smoke.py`` 9d's model: l1.5 regression in a9a's
    shape through 32,561 power cones (:func:`problems.pnorm_regression`),
    at 9a's settings with more iterations and a 300 s time limit."""
    from . import problems

    P, q, A, b, sets, _ = problems.pnorm_regression(*PNORM_SHAPE, seed=seed)
    return _model(device, (P, q, A, b, sets), PNORM_SETTINGS)


def _model(device, data, base):
    import cosmo_tpu_torch as pt

    def make(**overrides):
        return pt.Model(pt.Settings(**dict(base, **overrides)), device=device).set(*data)

    return make


def solve_rate(model):
    """One solve: its status, iterations, iter/s (iterations over the
    iteration loop's time, as ``chip_smoke.py`` reports them) and host
    waits an iteration."""
    res = model.optimize()
    info = model.last_solve
    return res.status, res.iter, res.iter / info["iter_time"], info["syncs"] / max(res.iter, 1)


def summed_ms(lib, stacks):
    """Ms of one launch of ``lib``'s kernel on each stack of ``stacks``
    (:func:`recorded_stacks`, either family), summed: the kernels' own
    durations from torch.profiler, the launches back to back after one
    warm-up launch (raises where it records another count of kernels)."""
    from torch.profiler import ProfilerActivity, profile

    args = (stacks["is_dual"], stacks["tol"], stacks["max_iter"], stacks["alpha"])
    launch(lib, stacks["V"][0], *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for V in stacks["V"].values():
            launch(lib, V, *args)
        torch.cuda.synchronize()
    family = "exp" if stacks["alpha"] is None else "pow"
    kernels = [e for e in prof.key_averages()
               if f"{family}_proj_kernel" in e.key and e.device_time_total > 0]
    if sum(e.count for e in kernels) != len(stacks["V"]):
        raise RuntimeError(f"torch.profiler recorded {sum(e.count for e in kernels)} "
                           f"{family} kernels of {len(stacks['V'])} launches")
    return sum(e.device_time_total for e in kernels) / 1e3


def plain_work(V, dual, tol, max_iter=MAX_ITER, alpha=None):
    """The plain version's rows and per-row work counts on these rows (the
    pow projection's with ``alpha``)."""
    stats = {}
    if alpha is None:
        ref = E.project_exp_plain(V, dual, tol, max_iter, stats=stats, per_row=True)
    else:
        ref = E.project_pow_plain(V, alpha, dual, tol, max_iter, stats=stats, per_row=True)
    return ref, stats


def wrapper_rows(other_ops, device, reps):
    """Each wrapper (``exp_proj_cuda``, ``pow_proj_cuda``) of this tree and
    of ``other_ops`` (another checkout's ``ops`` package, or None) on phase
    3's float64 rows: ``launch_ms``, ``device_ms``, their difference (the
    host's part of a call) and the device operations one call runs, by name
    (torch.profiler: those with device time)."""
    from torch.profiler import ProfilerActivity, profile

    V, dual, tol = cone_points(N, torch.float64, device, seed=N)
    alpha = torch.full((N,), 0.5, dtype=torch.float64, device=device)
    trees = {"this": exp_pow_proj}
    if other_ops is not None:
        trees["other"] = importlib.import_module(f"{other_ops}.exp_pow_proj")
    for family, args, it in (("exp", (V, dual, tol), MAX_ITER),
                             ("pow", (V, alpha, dual, tol), POW_MAX_ITER)):
        for tree, module in trees.items():
            fn = getattr(module, f"{family}_proj_cuda")
            call = lambda: fn(*args, it)  # noqa: E731
            a, b = launch_ms(call, reps), device_ms(call, max(1, reps // 4))
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kernels = {e.key: e.count for e in prof.key_averages()
                       if e.device_time_total > 0}
            print(f"wrapper {family}_proj_cuda, {tree}: launch_ms {a:.4f}, device_ms {b:.4f}, "
                  f"host part {a - b:.4f} ms, device operations a call "
                  f"{sum(kernels.values())} {sorted(kernels)}", flush=True)


def _build(builds):
    with ThreadPoolExecutor(len(builds)) as pool:
        return dict(zip(builds, pool.map(lambda build: build(), builds.values())))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", help="root of another checkout")
    parser.add_argument("--logistic", action="store_true",
                        help="also solve chip_smoke.py 9a and time its own exp stacks")
    parser.add_argument("--lanes", default="",
                        help="other lanes a cone to measure, comma-separated (1,7)")
    parser.add_argument("--pow", action="store_true",
                        help="the pow kernel in place of the exp kernel")
    parser.add_argument("--pnorm", action="store_true",
                        help="with --pow: also solve chip_smoke.py 9d and time its own stacks")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_exp needs a CUDA device")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    (main_pow if args.pow else main_exp)(args, device)


def main_exp(args, device):
    builds = {"this": cuda_build.exp_pow_library, "counting": profile_library}
    lanes = [int(n) for n in args.lanes.split(",") if n]
    builds.update({f"lanes {n}": lambda n=n: profile_library(n) for n in lanes})
    if args.other:
        builds["other"] = _other_cuda_build(Path(args.other).resolve()).exp_pow_library
    libs = _build(builds)
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
                    with recorded_stacks("exp", keep) as stacks:
                        status, iters, ips, _ = solve_rate(make())
                else:
                    status, iters, ips, _ = solve_rate(make())
            print(f"9a solve, {turn}: {status}, {iters} iterations, {ips:.2f} iter/s",
                  flush=True)
        n_proj = stacks["n"]
        for tree in order:
            print(f"9a's {n_proj} projections, kernel ms summed (torch.profiler): {tree} "
                  f"{summed_ms(libs[tree], stacks):.2f}", flush=True)
        for tree, lib in variants.items():
            print(f"9a's {n_proj} projections, kernel ms summed (torch.profiler): {tree} "
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


def main_pow(args, device):
    """``--pow``: the pow kernel on phase 3's rows (float32 and float64,
    alpha 0.3, 0.5, 0.8) and, with ``--pnorm``, on 9d's first, middle and
    last stacks; each row set against the plain version's bits and the
    other tree's kernel's, timed in turns. With ``--pnorm`` 9d is solved in
    turns (other, this, this, other, each keeping the stacks
    ``chip_smoke.py`` keeps, then this with every stack recorded) for its
    iter/s, and each kernel's time summed over the last solve's
    projections from torch.profiler's kernel durations. Then the wrappers of
    both trees (:func:`wrapper_rows`)."""
    other = Path(args.other).resolve() if args.other else None
    builds = {"this": cuda_build.exp_pow_library}
    if other is not None:
        builds["other"] = _other_cuda_build(other).exp_pow_library
    libs = _build(builds)
    order = ["other", "this", "this", "other"] if other is not None else ["this", "this"]
    sets = []
    for dtype in (torch.float32, torch.float64):
        V, dual, tol = cone_points(N, dtype, device, seed=N)
        for a in (0.3, 0.5, 0.8):
            alpha = torch.full((N,), a, dtype=dtype, device=device)
            sets.append((f"cone_points({N}) {str(dtype)[6:]} alpha {a}",
                         (V, dual, tol, POW_MAX_ITER, alpha)))
    if args.pnorm:
        make = pnorm_model(device)
        solve_rate(make(max_iter=25))  # warm-up
        for turn in order + ["every stack"]:
            keep = None if turn == "every stack" else (0, PNORM_MIDDLE)
            with exp_library(libs["other" if turn == "other" else "this"]):
                with recorded_stacks("pow", keep) as stacks:
                    status, iters, ips, waits = solve_rate(make())
            print(f"9d solve, {turn}: {status}, {iters} iterations, {ips:.2f} iter/s, "
                  f"{waits:.2f} host waits an iteration", flush=True)
        n_proj = stacks["n"]
        for tree in order:
            print(f"9d's {n_proj} projections, kernel ms summed (torch.profiler): {tree} "
                  f"{summed_ms(libs[tree], stacks):.3f}", flush=True)
        for name, k in (("first", 0), ("middle", PNORM_MIDDLE), ("last", n_proj - 1)):
            sets.append((f"9d projection {k} of {n_proj} ({name})",
                         (recorded_stack(stacks, k), stacks["is_dual"], stacks["tol"],
                          stacks["max_iter"], stacks["alpha"])))
    for label, (V, dual, tol, it, alpha) in sets:
        ref, stats = plain_work(V, dual, tol, it, alpha)
        newton = stats["row_newton"][stats["row_evals"] > 0].double()
        print(f"{label}: cases {case_mix(V, dual, alpha, tol)}, Newton steps a case-4 row "
              f"{newton.mean().item() if newton.numel() else 0.0:.2f} (most "
              f"{int(stats['row_newton'].max())}), one thread a row: lane efficiency "
              f"{thread_layout_efficiency(stats['row_newton']):.4f}")
        times = {}
        for tree in order:
            fn = lambda: launch(libs[tree], V, dual, tol, it, alpha)  # noqa: E731
            times.setdefault(tree, []).append((launch_ms(fn, args.reps),
                                               device_ms(fn, max(1, args.reps // 4))))
        parent = launch(libs["other"], V, dual, tol, it, alpha) if other is not None else None
        for tree, pairs in times.items():
            got = launch(libs[tree], V, dual, tol, it, alpha)
            against = "" if parent is None else f", from other {differing_rows(got, parent)}"
            print(f"  {tree}: rows differing from plain {differing_rows(got, ref)}{against}; "
                  f"launch_ms {', '.join(f'{a:.4f}' for a, _ in pairs)}; device_ms "
                  f"{', '.join(f'{b:.4f}' for _, b in pairs)}", flush=True)
    wrapper_rows("_other_ops" if other is not None else None, device, args.reps)


if __name__ == "__main__":
    main()
