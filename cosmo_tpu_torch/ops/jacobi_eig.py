"""The amortized PSD projection: the warm-started Jacobi kernels, their plain
PyTorch version, and the wrapper the projection calls.

``cosmo_tpu.ops.eigh.psd_project_amortized`` carries each PSD bucket's
eigenbasis across ADMM iterations: it rotates W = V'XV in the
re-orthonormalised basis, then runs 2 Jacobi sweeps from it, or the full
sweeps when a block's off-diagonal mass says the basis went stale. The
sweep count is a traced scalar of a ``lax.fori_loop``. Here the stale flag
never leaves the card: the projection adds no host read. Which kernel
takes a side (:func:`kernel_for`):

* even 4..48 (``eigh.kernel_takes``): ``jacobi_eig`` (``csrc/jacobi_eig.cu``),
  the whole projection in one cooperative launch on (X, V_prev): the
  rotation, the staleness test over the stack, the sweeps (the count
  settled on the card behind a grid barrier) and the reconstruction;
* even k = 2 and the even k above 48 whose W fits the shared memory of the
  largest cluster (:func:`cluster_kernel_takes`): ``jacobi_eig_cluster``
  (``csrc/jacobi_eig_cluster.cu``, a thread-block cluster a matrix, W in
  distributed shared memory, one exchange of bulk copies a round, V
  replayed from a log of the angles), then P = V max(w, 0) V' as a batched
  product (``eigh.sym_reconstruct``);
* the other even k above 48 whose W fits the shared memory of one
  cooperative grid of up to 128 CTAs (:func:`grid_kernel_takes`: to 1,232 in
  float64, 1,792 in float32): ``jacobi_eig_grid``
  (``csrc/jacobi_eig_grid.cu``, W in the CTAs' shared memory, the CTAs
  exchanging through global memory and per-CTA round flags, V replayed
  from a log of the angles), the same reconstruction;
* the even k past that, up to 65,536 (:func:`large_kernel_takes`):
  ``jacobi_eig_large`` (``csrc/jacobi_eig_large.cu``, W and V in global
  memory, one cooperative launch with a grid barrier a round), the same
  reconstruction;
* an odd k: none. The reference's ``jacobi_eigh`` sends it to eigh, which
  ignores V0 (``eigh.amortized_eigh``), and so does the wrapper, on either
  device; the stale flag is not read.

* :func:`psd_project_amortized` — the wrapper: on a CUDA device one counted
  launch of ``jacobi_eig``, or at the other sides the torch rotation
  (``eigh.amortized_rotate``) and one counted launch of the side's kernel;
  on the CPU the plain version ``eigh.psd_project_amortized``. Launches count in
  ``psd_project_amortized.launches`` by (kernel, k, dtype name); the
  kernels tally their full-sweep launches on the device, one tally for
  each of those keys (:func:`full_sweep_counts` reads them at once).
* ``eigh.psd_project_amortized`` — ``jacobi_eig``'s function in PyTorch,
  and ``jacobi_eig_plain`` (``eigh.jacobi_eig_plain``) the large-side
  kernels': the Jacobi from V0 with the sweep count read on the host, then
  0.5 (P + P'). The CPU tests hold them to the JAX function;
  ``chip_smoke.py`` holds each kernel to its own on the card.

Each kernel has its launcher (``LAUNCHERS``: :func:`jacobi_eig_cuda`,
:func:`jacobi_eig_cluster_cuda`, :func:`jacobi_eig_grid_cuda`,
:func:`jacobi_eig_large_cuda`), which
checks its input once. A CUDA tensor of a side the launcher's kernel does
not take, of another type or layout raises, and a build or launch error
raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from . import cuda_build
from . import eigh as eigh_mod
from .eigh import jacobi_eig_plain, kernel_takes  # noqa: F401
from .jacobi_proj import pair_schedule

# the large-side kernel's largest k: its uint16 pair table's labels
LARGE_MAX_SIDE = 1 << 16

# the cluster kernel on an H100 (sm_90): the cluster sizes it launches, the
# largest the card schedules at the kernel's shared memory (16, which needs
# the non-portable size: cudaOccupancyMaxActiveClusters, printed by
# chip_smoke.py 10e), and the shared memory a block may use
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 16
SMEM_MAX = 232_448
# cluster_size takes the smallest cluster of at least CLUSTER_MIN CTAs whose
# CTAs turn at most CLUSTER_TILES 2x2 tiles a round (a CTA has up to 1,024
# threads): on an H100 clusters of 4 beat 1 and 2 at every bucket of
# maxcut-10k's amortized path, and 8 beat 4 at [8, 256] float64 (PERF.md
# §6, profile_cluster.py)
CLUSTER_MIN = 4
CLUSTER_TILES = 2560
# the grid kernel's CTAs a matrix at most (grid_ctas)
GRID_CTAS = 128


def large_kernel_takes(k: int) -> bool:
    """The sides of ``jacobi_eig_large``: even k = 2 and even k above the
    small kernel's 48 (up to its pair table's 65,536). ``kernel_for`` sends
    those that fit the cluster kernel there instead."""
    return k % 2 == 0 and (k == 2 or eigh_mod.KERNEL_MAX_SIDE < k <= LARGE_MAX_SIDE)


def cluster_smem_bytes(k: int, cluster: int, itemsize: int) -> int:
    """Shared memory of one CTA of ``jacobi_eig_cluster`` at side ``k`` in a
    cluster of ``cluster`` (``csrc/jacobi_eig_cluster.cu``,
    ``cluster_smem_bytes``): two round barriers (16 bytes); the CTA's 2 (M +
    1) columns (M = ceil(h / cluster) slots, h = k/2; each arc with one
    spare column; a column's stride k rounded up to 16 bytes); two rounds'
    mailboxes (8 cluster M entries); the angles (2 h); two rounds' pairs (8
    bytes a pair); two rounds' slot plans (40 bytes a slot each)."""
    h = k // 2
    M = -(-h // cluster)
    stride = -(-k * itemsize // 16) * 16 // itemsize
    return (16 + (2 * (M + 1) * stride + 8 * cluster * M + 2 * h) * itemsize + 8 * h
            + 80 * M)


def _cluster_sizes(k: int, itemsize: int):
    """The cluster sizes whose CTAs hold W at side ``k``."""
    return [c for c in CLUSTER_SIZES if c <= min(MAX_CLUSTER, k // 2)
            and cluster_smem_bytes(k, c, itemsize) <= SMEM_MAX]


def cluster_kernel_takes(k: int, dtype) -> bool:
    """The sides of ``jacobi_eig_cluster`` in ``dtype`` (float32 or float64):
    the sides of ``jacobi_eig_large`` whose W fits the shared memory of the
    largest cluster, up to 896 in float32 and 608 in float64."""
    return large_kernel_takes(k) and bool(_cluster_sizes(k, dtype.itemsize))


def grid_ctas(k: int) -> int:
    """The CTAs of a ``jacobi_eig_grid`` launch at side ``k``: ``GRID_CTAS``
    (128; at most one a slot), one CTA an SM of the cooperative grid (an
    H100 has 132). On an H100 128 CTAs beat 64 at [1, 640] and [1, 768]
    float64 (PERF.md §6, ``profile_grid.py``)."""
    return min(GRID_CTAS, k // 2)


def grid_smem_bytes(k: int, ctas: int, itemsize: int) -> int:
    """Shared memory of one CTA of ``jacobi_eig_grid`` at side ``k`` with
    ``ctas`` CTAs (``csrc/jacobi_eig_grid.cu``, ``grid_layout``): 2 (M + 1)
    columns (M = ceil(h / ctas) slots, h = k/2; each arc with one spare
    column; a column's stride k rounded up to 16 bytes); the CTA's
    ceil(k / ctas) rows of V; the angles (2 h); two rounds' pairs (8 bytes a
    pair); two rounds' slot plans (40 bytes a slot each) and the slots'
    rings (32 bytes a slot); each part rounded up to 16 bytes; 32 bytes of
    words the CTA's warps share."""
    h = k // 2
    M = -(-h // ctas)
    stride = -(-k * itemsize // 16) * 16

    def r16(n):
        return -(-n // 16) * 16

    return (2 * (M + 1) * stride + r16(-(-k // ctas) * k * itemsize) + r16(2 * h * itemsize)
            + r16(8 * h) + r16(80 * M) + r16(32 * M) + 32)


def grid_kernel_takes(k: int, dtype) -> bool:
    """The sides that ``jacobi_eig_grid`` takes in ``dtype``: those of
    ``jacobi_eig_large`` whose W and V's rows fit the shared memory of
    ``grid_ctas(k)`` CTAs (to 1,232 in float64, 1,792 in float32).
    ``kernel_for`` sends it those that no cluster holds."""
    return large_kernel_takes(k) and grid_smem_bytes(k, grid_ctas(k),
                                                     dtype.itemsize) <= SMEM_MAX


def kernel_for(k: int, dtype):
    """The kernel that takes side ``k`` in ``dtype`` on a CUDA device, the
    amortized backend's one rule: "jacobi_eig" (even 4..48),
    "jacobi_eig_cluster" (2 and the even sides above 48 whose W fits a
    cluster), "jacobi_eig_grid" (the other even sides whose W fits the
    cooperative grid's shared memory), "jacobi_eig_large" (the even sides
    past that, up to 65,536), or None (an odd k: the reference's eigh
    branch)."""
    if kernel_takes(k):
        return "jacobi_eig"
    if cluster_kernel_takes(k, dtype):
        return "jacobi_eig_cluster"
    if grid_kernel_takes(k, dtype):
        return "jacobi_eig_grid"
    return "jacobi_eig_large" if large_kernel_takes(k) else None


def cluster_size(B: int, k: int, itemsize: int, max_active) -> int:
    """The cluster size of a ``jacobi_eig_cluster`` launch on B matrices of
    side k: among the sizes whose CTAs hold W, those that run the B
    clusters in the fewest waves (``max_active(C)``: the clusters of size C
    the card holds at once); of these the smallest of at least
    ``CLUSTER_MIN`` (or the largest there is) whose CTAs turn at most
    ``CLUSTER_TILES`` tiles a round, else the largest."""
    sizes = [c for c in _cluster_sizes(k, itemsize) if max_active(c) > 0]
    if not sizes:
        raise ValueError(f"jacobi_eig_cluster: no cluster holds side {k} on this card")
    waves = {c: -(-B // max_active(c)) for c in sizes}
    fewest = [c for c in sizes if waves[c] == min(waves.values())]
    h = k // 2
    least = min(CLUSTER_MIN, max(fewest))
    small = [c for c in fewest if c >= least and h * -(-h // c) <= CLUSTER_TILES]
    return min(small) if small else max(fewest)


@lru_cache(maxsize=None)
def _schedule_on(k: int, device: torch.device, dtype=np.uint8) -> torch.Tensor:
    table = pair_schedule(k, dtype)
    # the uint16 table goes over as int16: the kernel reads the same bits
    return torch.as_tensor(table if dtype == np.uint8 else table.view(np.int16),
                           device=device)


def _check(name, T, like):
    if T.device != like.device or T.dtype != like.dtype or T.shape != like.shape:
        raise ValueError(f"jacobi_eig: {name} must match W's device, type and shape, "
                         f"got {T.device} {T.dtype} {tuple(T.shape)}")
    if not T.is_contiguous():
        raise ValueError(f"jacobi_eig: {name} must be contiguous")


def _check_inputs(name, takes, W, V0, stale, n_full):
    if W.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {W.device}")
    if W.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32/float64, got {W.dtype}")
    if W.dim() != 3 or W.shape[1] != W.shape[2] or not takes(W.shape[1]):
        raise ValueError(f"{name} does not take a stack of shape {tuple(W.shape)} "
                         f"(kernel_for says which kernel takes a side)")
    _check("W", W, W)
    _check("V0", V0, W)
    if stale is not None and (stale.device != W.device or stale.dtype != torch.bool
                              or stale.numel() != 1):
        raise ValueError("jacobi_eig: stale must be one bool on W's device")
    if n_full is not None and (n_full.device != W.device or n_full.dtype != torch.int32):
        raise ValueError("jacobi_eig: n_full must be an int32 tensor on W's device")


# jacobi_eig's three device ints on each device: the epoch and the stale
# flag's two slots (zero at first; each launch leaves them so for the next,
# so the launches on a device must run in one stream's order)
_SYNC: dict = {}


def _sync_words(device) -> torch.Tensor:
    device = _device(device)
    if str(device) not in _SYNC:
        _SYNC[str(device)] = torch.zeros(3, dtype=torch.int32, device=device)
    return _SYNC[str(device)]


def jacobi_eig_cuda(X, V_prev, warm: int, full: int, n_full=None):
    """Launch ``jacobi_eig`` on ``X`` and ``V_prev`` [B, k, k] (contiguous
    float32/float64 CUDA tensors of an even side 4..48, ``kernel_takes``)
    on the current stream: the whole amortized projection
    (``eigh.psd_project_amortized``) in one cooperative launch, ``full``
    sweeps when any block is stale, else ``warm``, the flag never leaving
    the card. ``n_full``, an int32 CUDA tensor of one element, counts the
    launches that ran the full sweeps (on the device). Returns (P, V,
    stale), ``stale`` the 0-d bool the kernel decided on. Does not count
    launches. A stack the card cannot hold at once in the launch's
    persistent grid is walked by it; a launch the card refuses raises."""
    _check_inputs("jacobi_eig", kernel_takes, X, V_prev, None, n_full)
    B, k, _ = X.shape
    P, V = torch.empty_like(X), torch.empty_like(X)
    if B == 0:
        return P, V, torch.zeros((), dtype=torch.bool, device=X.device)
    stale = torch.empty((), dtype=torch.bool, device=X.device)
    lib = cuda_build.jacobi_library()
    fn = lib.jacobi_eig_f32 if X.dtype == torch.float32 else lib.jacobi_eig_f64
    err = fn(X.data_ptr(), V_prev.data_ptr(), P.data_ptr(), V.data_ptr(),
             _schedule_on(k, X.device).data_ptr(), stale.data_ptr(),
             _sync_words(X.device).data_ptr(), int(warm), int(full),
             None if n_full is None else n_full.data_ptr(), B, k,
             torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, {X.dtype})")
    return P, V, stale


@lru_cache(maxsize=None)
def eig_wave(k: int, dtype, device_index: int) -> int:
    """The matrices of side ``k`` in ``dtype`` that one wave of
    ``jacobi_eig``'s persistent grid holds on the card ``device_index``: a
    larger stack has warps that walk several groups. Builds the library."""
    lib = cuda_build.jacobi_library()
    fn = lib.jacobi_eig_wave_f32 if dtype == torch.float32 else lib.jacobi_eig_wave_f64
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(k, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"jacobi_eig: the occupancy query failed: CUDA error {err} "
                           f"(k={k}, {dtype})")
    return out.value


@lru_cache(maxsize=None)
def max_active_clusters(k: int, cluster: int, dtype, device_index: int) -> int:
    """cudaOccupancyMaxActiveClusters of ``jacobi_eig_cluster`` at side
    ``k`` in clusters of ``cluster`` on the card ``device_index``: how many
    such clusters it runs at once (0: none fits). Builds the library."""
    lib = cuda_build.jacobi_library()
    fn = (lib.jacobi_eig_cluster_max_active_f32 if dtype == torch.float32
          else lib.jacobi_eig_cluster_max_active_f64)
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(k, cluster, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"jacobi_eig_cluster: the occupancy query failed: CUDA error "
                           f"{err} (k={k}, cluster={cluster}, {dtype})")
    return out.value


def jacobi_eig_cluster_cuda(W, V0, stale, warm: int, full: int, n_full=None,
                            cluster=None):
    """Launch ``jacobi_eig_cluster`` on ``W`` and ``V0`` [B, k, k]
    (contiguous float32/float64 CUDA tensors of a side of
    :func:`cluster_kernel_takes`) on the current stream, with ``stale`` a
    0-d bool CUDA tensor: ``full`` sweeps from V0 when it is set, else
    ``warm``, in one cluster a matrix (``cluster`` CTAs, by
    default :func:`cluster_size`'s choice), the angles logged and replayed
    on V0 by a second launch, then P = V max(w, 0) V' from W's diagonal as
    a batched product (``eigh.sym_reconstruct``). Returns (P, V). Does not
    count launches."""
    _check_inputs("jacobi_eig_cluster", lambda k: cluster_kernel_takes(k, W.dtype), W,
                  V0, stale, n_full)
    B, k, _ = W.shape
    w = torch.empty((B, k), dtype=W.dtype, device=W.device)
    V = torch.empty_like(W)
    if B == 0:
        return torch.empty_like(W), V
    index = _device(W.device).index
    if cluster is None:
        cluster = cluster_size(B, k, W.dtype.itemsize,
                               lambda c: max_active_clusters(k, c, W.dtype, index))
    # the angle log: (c, s) of every slot of every round the call can run,
    # and the rounds each CTA has logged (the V replay follows them)
    angle_log = torch.empty(max(1, B * max(warm, full) * (k - 1) * k), dtype=W.dtype,
                            device=W.device)
    progress = torch.zeros(B * cluster, dtype=torch.int32, device=W.device)
    lib = cuda_build.jacobi_library()
    fn = lib.jacobi_eig_cluster_f32 if W.dtype == torch.float32 else lib.jacobi_eig_cluster_f64
    err = fn(W.data_ptr(), V0.data_ptr(), w.data_ptr(), V.data_ptr(), angle_log.data_ptr(),
             progress.data_ptr(), stale.data_ptr(), int(warm), int(full),
             None if n_full is None else n_full.data_ptr(), B, k, int(cluster),
             torch.cuda.current_stream(W.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig_cluster kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, cluster={cluster}, {W.dtype})")
    return eigh_mod.sym_reconstruct(w, V), V


def jacobi_eig_grid_cuda(W, V0, stale, warm: int, full: int, n_full=None, ctas=None):
    """Launch ``jacobi_eig_grid`` on ``W`` and ``V0`` [B, k, k] (contiguous
    float32/float64 CUDA tensors of a side of :func:`grid_kernel_takes`) on
    the current stream, with ``stale`` a 0-d bool CUDA tensor: ``full``
    sweeps from V0 when it is set, else ``warm``, in one cooperative grid
    of ``ctas`` CTAs (by default :func:`grid_ctas`), the matrices in turn,
    W in the CTAs' shared memory, the angles logged and replayed on V0 in
    the same launch; then P = V max(w, 0) V' from W's diagonal as a
    batched product (``eigh.sym_reconstruct``). Returns (P, V). Does not
    count launches. A fault on the card (a CTA that never publishes its
    round) ends the launch, and the stream's next synchronisation raises."""
    _check_inputs("jacobi_eig_grid", lambda k: grid_kernel_takes(k, W.dtype), W, V0,
                  stale, n_full)
    if W.shape[0] == 0:
        return torch.empty_like(W), torch.empty_like(W)
    ctas = grid_ctas(W.shape[1]) if ctas is None else int(ctas)
    w, V = launch_grid(cuda_build.jacobi_library(), W, V0, stale, warm, full, n_full, ctas)
    return eigh_mod.sym_reconstruct(w, V), V


def launch_grid(lib, W, V0, stale, warm: int, full: int, n_full, ctas: int):
    """One launch of ``lib``'s ``jacobi_eig_grid`` entry (the Jacobi
    library's, or a :func:`cuda_build.variant_library` of its source) on
    checked inputs of B > 0 matrices, on the current stream: (W's diagonal
    after the sweeps [B, k], V [B, k, k]). Raises if the launch reports an
    error; a wait that gives up on the card raises at the stream's next
    synchronisation."""
    B, k, _ = W.shape
    w = torch.empty((B, k), dtype=W.dtype, device=W.device)
    V = torch.empty_like(W)
    t = "f32" if W.dtype == torch.float32 else "f64"
    # the angle log of every round the call can run, the mailboxes, the
    # inboxes and a row-major copy of W; the CTAs' round flags, zero
    entries = getattr(lib, f"jacobi_eig_grid_scratch_{t}")(k, ctas,
                                                          max(warm, full) * (k - 1))
    scratch = torch.empty(entries, dtype=W.dtype, device=W.device)
    flags = torch.zeros(lib.jacobi_eig_grid_flag_ints(ctas), dtype=torch.int32,
                        device=W.device)
    err = getattr(lib, f"jacobi_eig_grid_{t}")(
        W.data_ptr(), V0.data_ptr(), w.data_ptr(), V.data_ptr(), scratch.data_ptr(),
        flags.data_ptr(), stale.data_ptr(), int(warm), int(full),
        None if n_full is None else n_full.data_ptr(), B, k, ctas,
        torch.cuda.current_stream(W.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig_grid kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, ctas={ctas}, {W.dtype})")
    return w, V


def jacobi_eig_large_cuda(W, V0, stale, warm: int, full: int, n_full=None):
    """Launch ``jacobi_eig_large`` on ``W`` and ``V0`` [B, k, k] (contiguous
    float32/float64 CUDA tensors of side 2 or an even side above 48,
    :func:`large_kernel_takes`) on the current stream: the sweeps of
    :func:`jacobi_eig_cluster_cuda`, then P = V max(w, 0) V' from W's diagonal
    after them as a batched product (``eigh.sym_reconstruct``). Returns
    (P, V). Does not count launches."""
    _check_inputs("jacobi_eig_large", large_kernel_takes, W, V0, stale, n_full)
    B, k, _ = W.shape
    w = torch.empty((B, k), dtype=W.dtype, device=W.device)
    V = torch.empty_like(W)
    if B == 0:
        return torch.empty_like(W), V
    scratch = torch.empty((2, B, k, k), dtype=W.dtype, device=W.device)
    lib = cuda_build.jacobi_library()
    fn = lib.jacobi_eig_large_f32 if W.dtype == torch.float32 else lib.jacobi_eig_large_f64
    err = fn(W.data_ptr(), V0.data_ptr(), w.data_ptr(), V.data_ptr(), scratch.data_ptr(),
             _schedule_on(k, W.device, np.uint16).data_ptr(), stale.data_ptr(),
             int(warm), int(full), None if n_full is None else n_full.data_ptr(), B, k,
             torch.cuda.current_stream(W.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eig_large kernel launch failed: CUDA error {err} "
                           f"(B={B}, k={k}, {W.dtype})")
    return eigh_mod.sym_reconstruct(w, V), V


# kernel_for's name -> its launcher: jacobi_eig's takes (X, V_prev, warm,
# full, n_full), the others (W, V0, stale, warm, full, n_full) after
# eigh.amortized_rotate
LAUNCHERS = {"jacobi_eig": jacobi_eig_cuda, "jacobi_eig_cluster": jacobi_eig_cluster_cuda,
             "jacobi_eig_grid": jacobi_eig_grid_cuda, "jacobi_eig_large": jacobi_eig_large_cuda}

# the device tallies of full-sweep launches, one int32 for each key of
# psd_project_amortized.launches on each device
_N_FULL: dict = {}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tally(key, device) -> torch.Tensor:
    device = _device(device)
    if (key, str(device)) not in _N_FULL:
        _N_FULL[key, str(device)] = torch.zeros(1, dtype=torch.int32, device=device)
    return _N_FULL[key, str(device)]


def full_sweep_counts(device="cuda") -> dict:
    """The launches on ``device`` that ran the full sweeps since the last
    :func:`reset_counts`, by the keys of ``psd_project_amortized.launches``
    (kernel, k, dtype name); one host read."""
    device = str(_device(device))
    keys = [key for key, dev in _N_FULL if dev == device]
    if not keys:
        return {}
    counts = torch.cat([_N_FULL[key, device] for key in keys]).tolist()
    return dict(zip(keys, counts))


def reset_counts():
    """Zero the launch counter and the device tallies of full sweeps."""
    psd_project_amortized.launches = Counter()
    for t in _N_FULL.values():
        t.zero_()


def launches_of(kernel: str) -> int:
    """The launches of ``kernel`` ("jacobi_eig", "jacobi_eig_cluster",
    "jacobi_eig_grid" or "jacobi_eig_large") counted since the last
    :func:`reset_counts`."""
    return sum(n for (name, _, _), n in psd_project_amortized.launches.items()
               if name == kernel)


def psd_project_amortized(X, V_prev, warm_sweeps: int = 2, full_sweeps: int = 8):
    """The amortized PSD projection of a stack [B, k, k] from the carried
    basis ``V_prev``: on a CUDA device one counted launch of ``jacobi_eig``
    on (X, V_prev) at the even sides 4..48, else :func:`eigh.amortized_rotate`
    and one counted launch of the side's kernel (:func:`kernel_for`, through
    its launcher in ``LAUNCHERS``), the stale flag never leaving the card,
    or at an odd side the reference's eigh branch; on the CPU the plain
    version :func:`eigh.psd_project_amortized`. Returns (P, V)."""
    if X.device.type == "cpu":
        return eigh_mod.psd_project_amortized(X, V_prev, warm_sweeps, full_sweeps)
    k = X.shape[-1]
    kernel = kernel_for(k, X.dtype)
    key = (kernel, k, str(X.dtype).split(".")[-1])
    if kernel == "jacobi_eig":
        P, V, _ = jacobi_eig_cuda(X.contiguous(), V_prev.contiguous(), warm_sweeps,
                                  full_sweeps, _tally(key, X.device))
        psd_project_amortized.launches[key] += 1
        return P, V
    W, V0, stale = eigh_mod.amortized_rotate(X, V_prev)
    if kernel is None:
        return eigh_mod.amortized_eigh(W)
    out = LAUNCHERS[kernel](W, V0, stale, warm_sweeps, full_sweeps, _tally(key, X.device))
    psd_project_amortized.launches[key] += 1
    return out


psd_project_amortized.launches = Counter()
