"""Compile an ordered list of cones into batched, padded arrays.

The port of ``cosmo_tpu.ops.conedata`` (reference: the CompositeConvexSet of
src/convexset.jl:885-891):

* Zero / Nonnegatives / Box rows (and 1x1 PSD blocks) collapse into one
  elementwise clip with per-row lower/upper bound vectors;
* second-order cones are bucketed by padded dimension into ``[B, d]``
  stacks (zero-padding is exact for the SOC projection);
* real PSD cones (square and svec-triangle storage) are bucketed by padded
  side into ``[B, k, k]`` stacks, projected one batched call per bucket.

Gather/scatter between the slack vector and the stacks use precomputed
index maps; padding lanes point at a one-past-the-end "dump" slot.

:func:`compile_cones` builds numpy arrays on the host; :func:`to_device`
moves the result to a torch device. Exponential, power, custom and complex
PSD cones, and the "shear"/"colpad" layouts of large PSD blocks, are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from ..models import cones as C
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

    ``fastpath == "matmul"``: a bucket of uniform-side triangle blocks in
    contiguous rows with k <= 64 expands svec -> full with one selection
    matmul (``expand`` [tri_len, k*k]) and compresses with another
    (``compress`` [k*k, tri_len]) instead of the index maps.
    ``backend``: per-bucket projection backend override ("" = the
    ConeData-wide one).
    """

    gather_idx: Any
    gather_scale: Any
    scatter_idx: Any
    scatter_scale: Any
    side: int
    symmetrize: bool
    fastpath: str = "none"     # "none" | "matmul"
    backend: str = ""
    contig_start: int = -1
    tri_len: int = 0
    r0: int = 0
    expand: Any = None
    compress: Any = None

    @property
    def batch(self) -> int:
        return self.gather_idx.shape[0]


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
    )


def resolve_eigh_backend(requested: str, buckets=None, accel_on: bool = True,
                         decomposed: bool = False, device="cpu") -> str:
    """Resolve an ``"auto"`` PSD projection backend for ``device`` — the
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
    if torch.device(device).type != "cuda":
        return "xla"
    if (buckets is not None and len(buckets) == 1
            and buckets[0].side <= AUTO_KERNEL_MAX_SIDE):
        if not accel_on:
            return "pallas"
        if decomposed and buckets[0].batch >= AUTO_KERNEL_MIN_BATCH:
            return "pallas"
    return "polar"


def _tri_index(i: int, j: int) -> int:
    """svec index of entry (i, j), i <= j, column-major upper triangle
    (reference packing order: src/convexset.jl:432-442)."""
    return j * (j + 1) // 2 + i


_NOT_PORTED_CONES = (
    (C.PsdConeTriangleColPad, "column-padded PSD storage (colpad layout)"),
    (C.PsdConeTriangleComplex, "complex PSD cones"),
    (C.ExponentialCone, "exponential cones"),
    (C.DualExponentialCone, "exponential cones"),
    (C.PowerCone, "power cones"),
    (C.DualPowerCone, "power cones"),
    (C.CustomCone, "custom cones"),
)


def compile_cones(sets: List[C.ConvexSet], dtype=np.float64, psd_pad_to: int = 8,
                  soc_pad_pow2: bool = True, eigh_backend: str = "xla",
                  jacobi_sweeps: int = 8, accel_on: bool = True,
                  decomposed: bool = False, device="cpu") -> ConeData:
    """Build the batched cone representation (numpy arrays) from an ordered
    cone list. ``device`` is where the solve will run: the ``"auto"``
    backend resolves for it (:func:`resolve_eigh_backend`)."""
    for cls, what in _NOT_PORTED_CONES:
        if any(isinstance(s, cls) for s in sets):
            raise not_ported(what, "exp/pow/custom/complex cones"
                             if cls is not C.PsdConeTriangleColPad
                             else "shear and colpad layouts")
    if eigh_backend in ("amortized", "jacobi_mm"):
        raise not_ported(f"eigh_backend={eigh_backend!r}",
                         "amortized/jacobi_mm backends")

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
    psd_groups: dict[tuple[int, bool], list[tuple[int, int]]] = {}  # (k, square) -> [(offset, r)]

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
        elif isinstance(cone, (C.SecondOrderCone, C.PsdCone, C.PsdConeTriangle)):
            if isinstance(cone, C.SecondOrderCone):
                pad = pad_side(d, 1 if not soc_pad_pow2 else 2)
                soc_groups.setdefault(pad, []).append((offset, d))
            elif cone.side <= 1:
                # 1x1 PSD block == nonnegativity (convexset.jl:303-308)
                lb[rows] = 0.0
                nonneg_mask[rows] = True
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
    for (k, square), blocks in psd_groups.items():
        norm_groups.setdefault(k, []).extend((o, r, square) for (o, r) in blocks)
    if psd_pad_to > 1:
        small_sides = [k for k in norm_groups if k <= 48]
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
    )


def _psd_bucket(k: int, blocks, DUMP: int, dtype) -> PsdBucket:
    """One bucket of side k from [(offset, r, square)] blocks."""
    # square (column-stacked) storage gathers an unsymmetrized matrix;
    # symmetrizing is a no-op for triangle storage, so a mixed bucket
    # symmetrizes everything
    symmetrize = any(square for (_, _, square) in blocks)
    B = len(blocks)
    g_idx = np.full((B, k, k), DUMP, dtype=np.int32)
    g_scl = np.zeros((B, k, k), dtype=dtype)
    s_idx = np.full((B, k, k), DUMP, dtype=np.int32)
    s_scl = np.zeros((B, k, k), dtype=dtype)

    # svec-triangle blocks: one [k, k] template per distinct side r,
    # broadcast over every block of that side
    tri_batch: dict[int, list[tuple[int, int]]] = {}
    for b, (o, r, square) in enumerate(blocks):
        if square:
            # column-stacked storage: vec index of (i, j) = o + j*r + i
            ii, jj = np.meshgrid(np.arange(r), np.arange(r), indexing="ij")
            g_idx[b, :r, :r] = o + jj * r + ii
            g_scl[b, :r, :r] = 1.0
            s_idx[b, :r, :r] = o + jj * r + ii
            s_scl[b, :r, :r] = 1.0
        else:
            tri_batch.setdefault(r, []).append((b, o))
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

    # uniform-side triangle blocks in contiguous rows -> selection-matmul
    # fast path (k <= 64); larger k would take the shear layout
    fastpath, contig_start, tri_len, r0u = "none", -1, 0, 0
    expand = compress = None
    rs = {r for (_, r, _) in blocks}
    if not symmetrize and len(rs) == 1:
        r0u = next(iter(rs))
        t0 = r0u * (r0u + 1) // 2
        offs = [o for (o, _, _) in blocks]
        if all(offs[i + 1] - offs[i] == t0 for i in range(len(offs) - 1)):
            if k > 64:
                raise not_ported(
                    f"the shear layout of a uniform PSD bucket of side {k}",
                    "shear and colpad layouts")
            fastpath = "matmul"
            contig_start = int(offs[0])
            tri_len = t0
            expand = np.zeros((t0, k * k), dtype)
            compress = np.zeros((k * k, t0), dtype)
            for j in range(r0u):
                for i in range(j + 1):
                    t = _tri_index(i, j)
                    scl = 1.0 if i == j else 1.0 / SQRT2
                    expand[t, i * k + j] = scl
                    expand[t, j * k + i] = scl
                    compress[i * k + j, t] = 1.0 if i == j else SQRT2
    return PsdBucket(
        gather_idx=g_idx, gather_scale=g_scl,
        scatter_idx=s_idx, scatter_scale=s_scl,
        side=k, symmetrize=symmetrize, fastpath=fastpath,
        contig_start=contig_start, tri_len=tri_len, r0=int(r0u),
        expand=expand, compress=compress,
    )
