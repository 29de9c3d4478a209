"""Compile an ordered list of cones into batched, padded arrays.

The port of ``cosmo_tpu.ops.conedata`` (reference: the CompositeConvexSet of
src/convexset.jl:885-891):

* Zero / Nonnegatives / Box rows (and 1x1 PSD blocks) collapse into one
  elementwise clip with per-row lower/upper bound vectors;
* second-order cones are bucketed by padded dimension into ``[B, d]``
  stacks (zero-padding is exact for the SOC projection);
* PSD cones (square, svec-triangle and column-padded svec storage, and
  complex Hermitian blocks through their real 2r x 2r embedding) are
  bucketed by padded side into ``[B, k, k]`` stacks, projected one batched
  call per bucket;
* exponential and power cones become ``[N, 3]`` stacks
  (:class:`ExpCones`, :class:`PowCones`) projected by one kernel launch a
  family; dual cones ride the same stacks by a per-row flag;
* custom cones keep their offset and their user object.

Gather/scatter between the slack vector and the stacks use precomputed
index maps; padding lanes point at a one-past-the-end "dump" slot. A bucket
of uniform blocks in contiguous rows takes a layout fast path instead
(:class:`PsdBucket`): a selection matmul (small side), the slice-shear
(large side) or one reshape (column-padded storage).

:func:`compile_cones` builds numpy arrays on the host; :func:`to_device`
moves the result to a torch device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from ..models import cones as C
from .eigh import kernel_takes
from .linops import to_device as _array_to_device

SQRT2 = np.sqrt(2.0)

# geometric bucket ladder for PSD block padding (cosmo_tpu.ops.conedata)
GEOMETRIC_SIZES = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 320, 384, 448,
                   512, 576, 640, 704, 768, 832, 896, 960, 1024, 1152, 1280,
                   1408, 1536, 1664, 1792, 1920, 2048)

# the side limits of the hand-written Jacobi kernel (ops/jacobi_proj.py)
# and of the auto rule that selects it
AUTO_KERNEL_MAX_SIDE = 16
AUTO_KERNEL_MIN_BATCH = 256


def not_ported(what: str, item: str):
    """The error for a feature this package does not have yet; ``item`` is
    the deferred entry of ROADMAP.md Queue 1 that will port it."""
    return NotImplementedError(
        f"{what} is not ported to cosmo_tpu_torch yet "
        f"(ROADMAP.md Queue 1, deferred: {item})"
    )


def pad_side(r: int, pad_to: int = 8) -> int:
    """Padded length on the geometric ladder (multiple of ``pad_to``)."""
    if pad_to <= 1:
        return r
    for sz in GEOMETRIC_SIZES:
        if sz >= r and sz % pad_to == 0:
            return sz
    return -(-r // pad_to) * pad_to


@dataclasses.dataclass(frozen=True)
class SocBucket:
    """A stack of second-order cones padded to a common dimension."""

    idx: Any  # int [B, d] gather/scatter rows into s (m == dump slot)


@dataclasses.dataclass(frozen=True)
class PsdBucket:
    """A stack of PSD blocks (square or triangle storage) padded to side k.

    gather:   X[b,i,j] = s_ext[gather_idx[b,i,j]] * gather_scale[b,i,j]
    scatter:  s[scatter_idx[b,i,j]] = Y[b,i,j] * scatter_scale[b,i,j]

    Fast paths replace the index maps for a bucket of uniform blocks in
    contiguous rows from ``contig_start`` on (``tri_len`` rows a block,
    real side ``r0``):

    * ``"matmul"`` (triangle storage, k <= 64): svec -> full with one
      selection matmul (``expand`` [tri_len, k*k]), back with another
      (``compress`` [k*k, tri_len]);
    * ``"shear"`` (triangle storage, k > 64, where those matrices would be
      O(k^4)): svec column j is the contiguous run from j(j+1)/2, so the
      expansion is one gather of the [r0, r0] index ``sh_idx`` (column
      starts ``sh_starts`` plus 0..r0-1) from the block's rows padded by
      r0 zeros, a mask and scale, and a symmetrization; the compression
      one gather of the flat map ``sh_flat`` scaled by ``sh_csc``;
    * ``"colpad"`` (column-padded storage, r0 == k): the rows of a block
      ARE an [r0, r0] matrix with columns as rows, so the expansion is one
      reshape, a mask and scale, and a symmetrization; the compression one
      transpose scaled by ``cp_csc`` (0 on the pad slots).

    ``sh_scale`` [r0, r0] is the reference's mask and scale, columns as
    rows (1 on the diagonal); ``sym_scale`` is the same with 1/2 on the
    diagonal, so that ``U + U^T`` of the scaled stack is the symmetric
    matrix in two operations (halving and doubling are exact).
    ``backend``: per-bucket projection backend override ("" = the
    ConeData-wide one). ``split``: under a device mesh, the rank's
    :class:`~.shard.Shard` for a bucket of fewer blocks than ranks (the
    counterpart of the reference's ``spec``): its batch is replicated and
    the polar's products are split over the matrix rows
    (``cosmo_tpu_torch.parallel.shard_cones``).
    """

    gather_idx: Any
    gather_scale: Any
    scatter_idx: Any
    scatter_scale: Any
    side: int
    symmetrize: bool
    fastpath: str = "none"     # "none" | "matmul" | "shear" | "colpad"
    backend: str = ""
    contig_start: int = -1
    tri_len: int = 0
    r0: int = 0
    expand: Any = None
    compress: Any = None
    sh_starts: Any = None      # int [r0] column starts        (shear)
    sh_scale: Any = None       # [r0, r0] mask * scale, [j, i]  (shear, colpad)
    sh_flat: Any = None        # int [tri_len] flat i*r0+j map  (shear)
    sh_csc: Any = None         # [tri_len] compress scale       (shear)
    cp_csc: Any = None         # [r0, r0] compress mask*scale   (colpad)
    sh_idx: Any = None         # int [r0, r0] shear gather index (shear)
    sym_scale: Any = None      # [r0, r0] sh_scale, diagonal 1/2 (shear, colpad)
    split: Any = None

    @property
    def batch(self) -> int:
        return self.gather_idx.shape[0]


@dataclasses.dataclass(frozen=True)
class ExpCones:
    """The exponential cones, primal and dual, as [N, 3] row indices."""

    idx: Any       # int [N, 3]
    is_dual: Any   # bool [N]
    tol: Any = None       # [N] per-cone projection tolerance
    max_iter: int = 100   # the largest of the cones' bisection limits


@dataclasses.dataclass(frozen=True)
class PowCones:
    """The power cones, primal and dual, as [N, 3] row indices."""

    idx: Any       # int [N, 3]
    alpha: Any     # [N]
    is_dual: Any   # bool [N]
    tol: Any = None       # [N] per-cone projection tolerance
    max_iter: int = 20    # the largest of the cones' Newton limits


@dataclasses.dataclass(frozen=True)
class ConeData:
    """Batched representation of a Cartesian product of cones."""

    m: int
    n_rect_segments: int
    # PSD projection backend, resolved by compile_cones (Settings.eigh_backend)
    eigh_backend: str = "xla"
    jacobi_sweeps: int = 8
    lb: Any = None            # [m]
    ub: Any = None            # [m]
    eq_mask: Any = None       # bool [m]  ZeroSet rows
    nonneg_mask: Any = None   # bool [m]  Nonnegatives rows (incl. 1x1 PSD)
    box_mask: Any = None      # bool [m]  Box rows
    # Ruiz rectification segments: rows of segment i share one scaling
    # factor, the mean of their Ruiz row scalings (convexset.jl:953-958)
    rect_mask: Any = None     # bool [m]
    rect_seg: Any = None      # int [m] in [0, n_rect_segments]; dump == last
    soc_buckets: Tuple[SocBucket, ...] = ()
    psd_buckets: Tuple[PsdBucket, ...] = ()
    exp: ExpCones = None
    pow: PowCones = None
    # user-defined cones: ((offset, CustomCone), ...); their functions take
    # and return tensors on the solve's device
    custom: Tuple = ()
    # under a device mesh (cosmo_tpu_torch.parallel.shard_cones): the rank's
    # Shard, with the stacks holding this rank's slices, and the
    # Zero/Nonnegatives/Box rows whose clip this rank writes
    shard: Any = None
    own_rows: Any = None      # bool [m]


def _fields_to_device(obj, device, dtype):
    return dataclasses.replace(obj, **{
        f.name: _array_to_device(getattr(obj, f.name), device, dtype)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), (np.ndarray, torch.Tensor))
    })


def to_device(cones: ConeData, device, dtype: torch.dtype) -> ConeData:
    """Move every array of ``cones`` to ``device`` (floats in ``dtype``)."""
    cones = _fields_to_device(cones, device, dtype)
    return dataclasses.replace(
        cones,
        soc_buckets=tuple(_fields_to_device(b, device, dtype)
                          for b in cones.soc_buckets),
        psd_buckets=tuple(_fields_to_device(b, device, dtype)
                          for b in cones.psd_buckets),
        exp=None if cones.exp is None else _fields_to_device(cones.exp, device, dtype),
        pow=None if cones.pow is None else _fields_to_device(cones.pow, device, dtype),
    )


def _on_cuda(device) -> bool:
    """Whether ``device`` (None: ``cuda``) is a CUDA device."""
    return torch.device("cuda" if device is None else device).type == "cuda"


def resolve_eigh_backend(requested: str, buckets=None, accel_on: bool = True,
                         decomposed: bool = False, device=None) -> str:
    """Resolve an ``"auto"`` PSD projection backend for ``device`` (None:
    ``cuda``, where the package's entry points solve by default) — the
    rule of ``cosmo_tpu.ops.conedata.resolve_eigh_backend`` with "on TPU"
    read as "on a CUDA device":

    * on the CPU, ``torch.linalg.eigh`` ("xla");
    * a single bucket of side <= 16 without Anderson acceleration gets the
      Jacobi kernel ("pallas"); under Anderson only a decomposed problem
      with >= 256 blocks does (the kernel's f32 backward error of ~1e-5
      destabilizes safeguarded Anderson on dense-KKT problems);
    * everything else gets the Newton-Schulz polar projection.

    ``buckets=None`` (hand-built ConeData) resolves conservatively: never
    the kernel.
    """
    if requested != "auto":
        return requested
    if not _on_cuda(device):
        return "xla"
    if (buckets is not None and len(buckets) == 1
            and buckets[0].side <= AUTO_KERNEL_MAX_SIDE):
        if not accel_on:
            return "pallas"
        if decomposed and buckets[0].batch >= AUTO_KERNEL_MIN_BATCH:
            return "pallas"
    return "polar"


# the cones whose rows share one Ruiz scaling factor (convexset.jl:953-958)
_RECTIFIED = (C.SecondOrderCone, C.PsdCone, C.PsdConeTriangle, C.PsdConeTriangleColPad,
              C.PsdConeTriangleComplex, C.ExponentialCone, C.DualExponentialCone,
              C.PowerCone, C.DualPowerCone)


def _tri_index(i: int, j: int) -> int:
    """svec index of entry (i, j), i <= j, column-major upper triangle
    (reference packing order: src/convexset.jl:432-442)."""
    return j * (j + 1) // 2 + i


def compile_cones(sets: List[C.ConvexSet], dtype=np.float64, psd_pad_to: int = 8,
                  soc_pad_pow2: bool = True, eigh_backend: str = "xla",
                  jacobi_sweeps: int = 8, accel_on: bool = True,
                  decomposed: bool = False, device=None) -> ConeData:
    """Build the batched cone representation (numpy arrays) from an ordered
    cone list. ``device`` is where the solve will run (None: ``cuda``): the
    ``"auto"`` backend resolves for it (:func:`resolve_eigh_backend`).
    ``"amortized"`` on a CUDA device takes the sides of its Jacobi kernel
    (even 4..48, ``ops/jacobi_eig.py``) and raises for a bucket of another
    side; the CPU takes every side through the plain version."""

    m = sum(s.dim for s in sets)
    DUMP = m

    lb = np.full(m, -np.inf, dtype=dtype)
    ub = np.full(m, np.inf, dtype=dtype)
    eq_mask = np.zeros(m, dtype=bool)
    nonneg_mask = np.zeros(m, dtype=bool)
    box_mask = np.zeros(m, dtype=bool)
    rect_mask = np.zeros(m, dtype=bool)
    rect_seg = np.zeros(m, dtype=np.int32)

    soc_groups: dict[int, list[tuple[int, int]]] = {}   # d_pad -> [(offset, d)]
    # (k, kind) -> [(offset, r)]; kind: False triangle, True square storage,
    # "colpad" column-padded triangle storage, "complex" Hermitian storage
    psd_groups: dict[tuple[int, Any], list[tuple[int, int]]] = {}
    exp_rows: list[tuple[int, bool, float, int]] = []          # (o, dual, tol, it)
    pow_rows: list[tuple[int, float, bool, float, int]] = []   # (o, alpha, ...)
    custom: list = []

    n_rect = 0
    offset = 0
    for cone in sets:
        d = cone.dim
        rows = slice(offset, offset + d)
        if isinstance(cone, C.ZeroSet):
            lb[rows] = 0.0
            ub[rows] = 0.0
            eq_mask[rows] = True
        elif isinstance(cone, C.Nonnegatives):
            lb[rows] = 0.0
            nonneg_mask[rows] = True
        elif isinstance(cone, C.Box):
            lb[rows] = cone.l
            ub[rows] = cone.u
            box_mask[rows] = True
        elif isinstance(cone, C.CustomCone):
            custom.append((offset, cone))
            if cone.scalar_scaling:
                rect_mask[rows] = True
                rect_seg[rows] = n_rect
                n_rect += 1
        elif isinstance(cone, _RECTIFIED):
            if isinstance(cone, C.SecondOrderCone):
                pad = pad_side(d, 1 if not soc_pad_pow2 else 2)
                soc_groups.setdefault(pad, []).append((offset, d))
            elif isinstance(cone, (C.ExponentialCone, C.DualExponentialCone)):
                exp_rows.append((offset, isinstance(cone, C.DualExponentialCone),
                                 cone.tol, cone.max_iter))
            elif isinstance(cone, (C.PowerCone, C.DualPowerCone)):
                pow_rows.append((offset, cone.alpha, isinstance(cone, C.DualPowerCone),
                                 cone.tol, cone.max_iter))
            elif isinstance(cone, C.PsdConeTriangleColPad):
                # the chordal transform emits it pre-padded: the side IS
                # the storage stride, so no ladder padding applies
                psd_groups.setdefault((cone.side, "colpad"), []).append(
                    (offset, cone.side))
            elif cone.side <= 1:
                # a 1x1 PSD (or Hermitian) block is nonnegativity
                # (convexset.jl:303-308)
                lb[rows] = 0.0
                nonneg_mask[rows] = True
            elif isinstance(cone, C.PsdConeTriangleComplex):
                # the real 2r x 2r embedding [[A, -B], [B, A]] of H = A + iB
                # is symmetric with H's eigenvalues doubled, so the real
                # projection applies unchanged (convexset.jl:344-360)
                k = pad_side(2 * cone.side, psd_pad_to)
                psd_groups.setdefault((k, "complex"), []).append((offset, cone.side))
            else:
                square = isinstance(cone, C.PsdCone)
                k = pad_side(cone.side, psd_pad_to)
                psd_groups.setdefault((k, square), []).append((offset, cone.side))
            rect_mask[rows] = True
            rect_seg[rows] = n_rect
            n_rect += 1
        else:
            raise TypeError(f"Unsupported cone type: {type(cone).__name__}")
        offset += d

    # rows that are not in any rectified cone go to the dump segment
    rect_seg = np.where(rect_mask, rect_seg, n_rect).astype(np.int32)

    soc_buckets = []
    for d_pad, members in sorted(soc_groups.items()):
        idx = np.full((len(members), d_pad), DUMP, dtype=np.int32)
        for b, (o, d) in enumerate(members):
            idx[b, :d] = np.arange(o, o + d, dtype=np.int32)
        soc_buckets.append(SocBucket(idx=idx))

    # PSD buckets: group by padded side; collapse pathological shape
    # diversity (> 6 small sides) into the largest small side
    norm_groups: dict = {}
    for (k, kind), blocks in psd_groups.items():
        norm_groups.setdefault(k, []).extend((o, r, kind) for (o, r) in blocks)
    if psd_pad_to > 1:
        # colpad groups stay out: their maps are built at the block's own
        # storage stride r == k, and merging an r < k colpad block into a
        # larger side would index past its r*r rows into its neighbours'
        small_sides = [
            k for k, blocks in norm_groups.items()
            if k <= 48 and not any(kind == "colpad" for (_, _, kind) in blocks)
        ]
        if len(small_sides) > 6:
            target = max(small_sides)
            merged = []
            for k in small_sides:
                merged.extend(norm_groups.pop(k))
            norm_groups.setdefault(target, []).extend(merged)

    psd_buckets = []
    for k, blocks in sorted(norm_groups.items()):
        psd_buckets.append(_psd_bucket(k, blocks, DUMP, dtype))

    requested = eigh_backend
    eigh_backend = resolve_eigh_backend(eigh_backend, psd_buckets, accel_on,
                                        decomposed, device)
    if eigh_backend == "amortized" and _on_cuda(device):
        for b in psd_buckets:
            if not kernel_takes(b.side):
                raise not_ported(f"eigh_backend='amortized' on a PSD bucket of side "
                                 f"{b.side} on a CUDA device", "amortized above side 48")
    if (
        requested == "auto"
        and eigh_backend == "polar"
        and (not accel_on or decomposed)
        and len(psd_buckets) > 1
    ):
        # multi-bucket solves: the single dominant small-side large-batch
        # bucket gets the kernel (cosmo_tpu.ops.conedata, PsdBucket.backend)
        cand = [
            (b.batch * b.side**3, i)
            for i, b in enumerate(psd_buckets)
            if b.side <= AUTO_KERNEL_MAX_SIDE and b.batch >= AUTO_KERNEL_MIN_BATCH
        ]
        if cand:
            _, i_star = max(cand)
            psd_buckets[i_star] = dataclasses.replace(
                psd_buckets[i_star], backend="pallas"
            )

    return ConeData(
        m=m,
        n_rect_segments=n_rect,
        eigh_backend=eigh_backend,
        jacobi_sweeps=jacobi_sweeps,
        lb=lb, ub=ub,
        eq_mask=eq_mask, nonneg_mask=nonneg_mask, box_mask=box_mask,
        rect_mask=rect_mask, rect_seg=rect_seg,
        soc_buckets=tuple(soc_buckets),
        psd_buckets=tuple(psd_buckets),
        exp=_exp_cones(exp_rows, dtype),
        pow=_pow_cones(pow_rows, dtype),
        custom=tuple(custom),
    )


def _rows3(offsets) -> np.ndarray:
    return (np.asarray(offsets, np.int32).reshape(-1, 1)
            + np.arange(3, dtype=np.int32)[None, :])


def _exp_cones(rows, dtype) -> ExpCones:
    """The [N, 3] stack of the exponential cones, bisection limit the
    largest of theirs (cosmo_tpu.ops.conedata:613-628)."""
    return ExpCones(
        idx=_rows3([o for (o, *_r) in rows]),
        is_dual=np.array([d for (_, d, _t, _i) in rows], dtype=bool),
        tol=np.array([t for (_, _d, t, _i) in rows], dtype=dtype),
        max_iter=max((i for (*_r, i) in rows), default=100))


def _pow_cones(rows, dtype) -> PowCones:
    """The [N, 3] stack of the power cones, Newton limit the largest of
    theirs (cosmo_tpu.ops.conedata:630-645)."""
    return PowCones(
        idx=_rows3([o for (o, *_r) in rows]),
        alpha=np.array([a for (_, a, *_r) in rows], dtype=dtype),
        is_dual=np.array([d for (_, _a, d, _t, _i) in rows], dtype=bool),
        tol=np.array([t for (*_r, t, _i) in rows], dtype=dtype),
        max_iter=max((i for (*_r, i) in rows), default=20))


def layout_maps(bucket: PsdBucket) -> PsdBucket:
    """``bucket`` with the port's derived layout maps (``sh_idx``,
    ``sym_scale``) filled in from the reference's fields, for a shear or
    colpad bucket whose maps are numpy arrays; others come back as given."""
    if bucket.fastpath not in ("shear", "colpad") or bucket.sym_scale is not None:
        return bucket
    r0 = bucket.r0
    sym = np.array(bucket.sh_scale, copy=True)
    sym[np.diag_indices(r0)] *= 0.5
    sh_idx = None
    if bucket.fastpath == "shear":
        sh_idx = (np.asarray(bucket.sh_starts, np.int64)[:, None]
                  + np.arange(r0)[None, :])
    return dataclasses.replace(bucket, sh_idx=sh_idx, sym_scale=sym)


def _psd_bucket(k: int, blocks, DUMP: int, dtype) -> PsdBucket:
    """One bucket of side k from [(offset, r, kind)] blocks (kind: False
    triangle, True square, "colpad" column-padded triangle storage)."""
    kinds = {kind for (_, _, kind) in blocks}
    # square (column-stacked) storage gathers an unsymmetrized matrix;
    # symmetrizing is a no-op for the other storages, so a mixed bucket
    # symmetrizes everything
    symmetrize = True in kinds
    B = len(blocks)
    g_idx = np.full((B, k, k), DUMP, dtype=np.int32)
    g_scl = np.zeros((B, k, k), dtype=dtype)
    s_idx = np.full((B, k, k), DUMP, dtype=np.int32)
    s_scl = np.zeros((B, k, k), dtype=dtype)

    # svec-triangle blocks: one [k, k] template per distinct side r,
    # broadcast over every block of that side
    tri_batch: dict[int, list[tuple[int, int]]] = {}
    for b, (o, r, kind) in enumerate(blocks):
        if kind is True:
            # column-stacked storage: vec index of (i, j) = o + j*r + i
            ii, jj = np.meshgrid(np.arange(r), np.arange(r), indexing="ij")
            g_idx[b, :r, :r] = o + jj * r + ii
            g_scl[b, :r, :r] = 1.0
            s_idx[b, :r, :r] = o + jj * r + ii
            s_scl[b, :r, :r] = 1.0
        elif kind is False:
            tri_batch.setdefault(r, []).append((b, o))
        elif kind == "complex":
            _fill_complex(g_idx[b], g_scl[b], s_idx[b], s_scl[b], o, r)
    for r, bo in tri_batch.items():
        jj, ii = np.tril_indices(r)            # (i, j) with i <= j
        t = jj * (jj + 1) // 2 + ii            # _tri_index vectorized
        scl_g = np.where(ii == jj, 1.0, 1.0 / SQRT2).astype(dtype)
        scl_s = np.where(ii == jj, 1.0, SQRT2).astype(dtype)
        bs = np.asarray([b for (b, _) in bo], np.int64)
        os_ = np.asarray([o for (_, o) in bo], np.int64)
        tb = (os_[:, None] + t[None, :]).astype(np.int32)   # [Nb, T]
        bb = np.broadcast_to(bs[:, None], tb.shape)
        iB = np.broadcast_to(ii[None, :], tb.shape)
        jB = np.broadcast_to(jj[None, :], tb.shape)
        g_idx[bb, iB, jB] = tb
        g_idx[bb, jB, iB] = tb
        g_scl[bb, iB, jB] = scl_g[None, :]
        g_scl[bb, jB, iB] = scl_g[None, :]
        s_idx[bb, iB, jB] = tb
        s_scl[bb, iB, jB] = scl_s[None, :]

    # colpad blocks (r == k): the gather reads the stored upper entry for
    # both (i, j) and (j, i); the scatter writes the upper entries scaled
    # and the strictly-lower pad slots with scale 0, so every row of the
    # block is written on this route too
    cp_blocks = [(b, o) for b, (o, r, kind) in enumerate(blocks) if kind == "colpad"]
    if cp_blocks:
        iu, ju = np.triu_indices(k)            # i <= j
        t = ju * k + iu                        # stored slot, column-major
        scl_g = np.where(iu == ju, 1.0, 1.0 / SQRT2).astype(dtype)
        scl_s = np.where(iu == ju, 1.0, SQRT2).astype(dtype)
        il, jl = np.tril_indices(k, -1)        # i > j: pad slots
        tl = jl * k + il
        for b, o in cp_blocks:
            g_idx[b, iu, ju] = o + t
            g_idx[b, ju, iu] = o + t
            g_scl[b, iu, ju] = scl_g
            g_scl[b, ju, iu] = scl_g
            s_idx[b, iu, ju] = o + t
            s_scl[b, iu, ju] = scl_s
            s_idx[b, il, jl] = o + tl
            s_scl[b, il, jl] = 0.0

    # uniform blocks in contiguous rows -> a layout fast path
    fastpath, contig_start, tri_len, r0u = "none", -1, 0, 0
    expand = compress = None
    sh_starts = sh_scale = sh_flat = sh_csc = cp_csc = None
    rs = {r for (_, r, _) in blocks}
    offs = [o for (o, _, _) in blocks]
    if len(rs) == 1 and kinds in ({"colpad"}, {False}):
        r0u = next(iter(rs))
        jr = np.arange(r0u)
        # columns as rows: [j, i] holds entry (i, j) for i <= j
        mask = jr[None, :] <= jr[:, None]
        diag = jr[None, :] == jr[:, None]
        step = r0u * r0u if kinds == {"colpad"} else r0u * (r0u + 1) // 2
        if all(offs[i + 1] - offs[i] == step for i in range(len(offs) - 1)):
            contig_start, tri_len = int(offs[0]), step
            if kinds == {"colpad"}:
                fastpath = "colpad"
                sh_scale = np.where(diag, 1.0, 1.0 / SQRT2).astype(dtype) * mask
                cp_csc = np.where(diag, 1.0, SQRT2).astype(dtype) * mask
            elif k <= 64:
                # the selection matrices are O(k^4): a few MB at k <= 64
                fastpath = "matmul"
                expand = np.zeros((step, k * k), dtype)
                compress = np.zeros((k * k, step), dtype)
                for j in range(r0u):
                    for i in range(j + 1):
                        t = _tri_index(i, j)
                        scl = 1.0 if i == j else 1.0 / SQRT2
                        expand[t, i * k + j] = scl
                        expand[t, j * k + i] = scl
                        compress[i * k + j, t] = 1.0 if i == j else SQRT2
            else:
                fastpath = "shear"
                sh_starts = (jr * (jr + 1) // 2).astype(np.int32)
                sh_scale = np.where(diag, 1.0, 1.0 / SQRT2).astype(dtype) * mask
                jj_t = np.repeat(jr, jr + 1)
                ii_t = np.arange(step) - (jj_t * (jj_t + 1) // 2)
                sh_flat = (ii_t * r0u + jj_t).astype(np.int32)
                sh_csc = np.where(ii_t == jj_t, 1.0, SQRT2).astype(dtype)
    return layout_maps(PsdBucket(
        gather_idx=g_idx, gather_scale=g_scl,
        scatter_idx=s_idx, scatter_scale=s_scl,
        side=k, symmetrize=symmetrize, fastpath=fastpath,
        contig_start=contig_start, tri_len=tri_len, r0=int(r0u),
        expand=expand, compress=compress, sh_starts=sh_starts,
        sh_scale=sh_scale, sh_flat=sh_flat, sh_csc=sh_csc, cp_csc=cp_csc,
    ))


def _fill_complex(g_idx, g_scl, s_idx, s_scl, o: int, r: int):
    """The [k, k] maps of one Hermitian block at offset ``o`` (side r), in
    place (cosmo_tpu.ops.conedata:496-522). H = A + iB is stored as
    [svec(A); sqrt(2) * strict-upper(B)] (convexset.jl:446-490); the
    gather builds M = [[A, -B], [B, A]], the scatter reads the real parts
    from M's top-left block and the imaginary parts from its bottom-left."""
    isq = 1.0 / SQRT2
    jj, ii = np.tril_indices(r)                # (i, j) with i <= j
    t = o + jj * (jj + 1) // 2 + ii
    scl = np.where(ii == jj, 1.0, isq)
    for (a, b) in ((ii, jj), (jj, ii), (r + ii, r + jj), (r + jj, r + ii)):
        g_idx[a, b] = t
        g_scl[a, b] = scl
    s_idx[ii, jj] = t
    s_scl[ii, jj] = np.where(ii == jj, 1.0, SQRT2)
    jj, ii = np.tril_indices(r, -1)            # (i, j) with i < j
    t = o + r * (r + 1) // 2 + jj * (jj - 1) // 2 + ii
    for (a, b, sgn) in ((r + ii, jj, 1.0), (r + jj, ii, -1.0),
                        (ii, r + jj, -1.0), (jj, r + ii, 1.0)):
        g_idx[a, b] = t
        g_scl[a, b] = sgn * isq
    s_idx[r + ii, jj] = t
    s_scl[r + ii, jj] = SQRT2
