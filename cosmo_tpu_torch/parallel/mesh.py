"""Device-mesh sharding of the conic ADMM solve over ``torch.distributed``
(the port of ``cosmo_tpu.parallel.mesh``).

The reference shards one jitted solve over a 1-D ``jax.sharding.Mesh`` and
lets GSPMD insert the collectives. Here every rank of a process group runs
the same solve on the same problem (SPMD) and the collectives are explicit
(``ops/shard.py``); the layout is the reference's, rule by rule:

* PSD buckets with at least as many blocks as ranks are split along the
  batch, padded with dump-slot blocks to a multiple of the rank count; a
  bucket keeps its matmul, shear or colpad fast path when its batch
  divides the ranks. A bucket of fewer blocks keeps its batch on every
  rank and splits the polar's products over the matrix rows
  (``PsdBucket.split``);
* SOC, exponential and power stacks are split along the batch, padded
  with dump-slot cones;
* the Zero/Nonnegatives/Box rows are split among the ranks when the row
  count divides the ranks, else rank 0 writes them; a dense A is split by
  rows under the same rule (:class:`~cosmo_tpu_torch.ops.linops.RowShard`);
* a ``Coo`` A is split along its nnz in segment-aligned chunks, so every
  output entry of a product is summed on one rank and the reassembling sum
  adds exact zeros: the sharded products are bit-identical to the
  single-process ones;
* P, q, b and every vector the ADMM loop carries are replicated;
* the block KKT's components are split over the ranks, each rank holding
  the pair lists of its own, remapped into the padded nnz layout.

Every rank reads the same problem, so the sharded structures are cut from
the host (numpy) ones on each rank, with no communication.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops import blockkkt, conedata, linops
from ..ops.shard import Shard

BLOCK_AXIS = "blocks"

# Observability: the most recent shard_cones cost accounting (see
# psd_cost_report); the model's verbose output prints it and tests read it.
LAST_SHARD_REPORT: dict | None = None


def _np(x):
    """A tensor or array as a numpy array (None passes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return None if x is None else np.asarray(x)


def psd_cost_report(cones, n_dev: int) -> dict:
    """Per-rank projection-cost accounting for the PSD buckets of an
    (unsharded) ConeData over ``n_dev`` ranks
    (``cosmo_tpu.parallel.mesh.psd_cost_report``, the same cost model and
    keys): a block of side k costs k^3; a bucket of B >= n_dev blocks is
    batch-sharded, padded to a multiple of n_dev; a smaller one is
    matrix-row sharded, ``B k^3 / n_dev`` a rank plus one [k, k] exchange
    a polar product (``ici_bytes_scale``). ``pad_waste`` is the summed
    largest per-rank cost over the real cost, ``imbalance`` the largest
    per-rank cost over the mean."""
    buckets = []
    per_dev = np.zeros(n_dev)
    cost_real = 0.0
    ici_bytes = 0.0
    for bkt in cones.psd_buckets:
        B = int(bkt.gather_idx.shape[0])
        k = int(bkt.side)
        # dummy blocks gather only the dump slot: all scales exactly 0
        scal = _np(bkt.gather_scale)
        b_real = int(np.sum(np.any(scal != 0, axis=(1, 2))))
        cost_real += b_real * k**3
        if B < n_dev:
            per_dev += B * k**3 / n_dev
            ici_bytes += 49 * B * k * k * 4
            buckets.append(dict(k=k, B_real=b_real, B_padded=B,
                                layout="matrix_sharded",
                                local_per_device=B))
        else:
            b_tot = B + ((-B) % n_dev)
            per_dev += (b_tot // n_dev) * k**3
            buckets.append(dict(k=k, B_real=b_real, B_padded=b_tot,
                                layout="batch_sharded",
                                local_per_device=b_tot // n_dev))
    return dict(
        n_dev=n_dev,
        imbalance=round(float(per_dev.max() / per_dev.mean()), 4)
        if per_dev.mean() else 1.0,
        pad_waste=round(float(per_dev.max() * n_dev / cost_real), 4)
        if cost_real else 1.0,
        cost_real_flops_scale=cost_real,
        cost_per_device_scale=float(per_dev.max()),
        ici_bytes_scale=ici_bytes,
        buckets=buckets,
    )


def make_mesh(n_devices: int | None = None, axis: str = BLOCK_AXIS):
    """A 1-D ``DeviceMesh`` named ``axis`` over the first ``n_devices``
    ranks (all of them by default) of the default process group, which the
    caller has initialised (``torch.distributed.init_process_group``: gloo
    or NCCL). Raises when no group is initialised or it has fewer ranks
    than asked for. A rank solves on ``cuda:<local rank % device count>``
    where CUDA is available (so gloo ranks on a one-card machine share
    ``cuda:0``), else on the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise RuntimeError(f"Requested {n} ranks but only {world} are available.")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def is_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def mesh_device(mesh) -> torch.device:
    """The device this rank solves on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_shard(mesh) -> Shard:
    """This rank's :class:`~cosmo_tpu_torch.ops.shard.Shard` of ``mesh``,
    made once and kept on the mesh object, so that every structure of a
    solve counts its collectives in one place. Raises on a rank outside
    the mesh."""
    sh = getattr(mesh, "_cosmo_shard", None)
    if sh is None:
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        group = mesh.get_group()
        sh = Shard(group=group, rank=mesh.get_local_rank(), size=mesh.size(),
                   src=dist.get_global_rank(group, 0))
        mesh._cosmo_shard = sh
    return sh


def _pad_batch(arr, d: int, fill):
    """Pad the leading (batch) dim of ``arr`` up to a multiple of ``d``."""
    arr = np.asarray(arr)
    pad = (-arr.shape[0]) % d
    if pad == 0:
        return arr
    return np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)])


def _mine(arr, sh: Shard):
    """This rank's contiguous share of a batch padded to a multiple of the
    rank count."""
    per = arr.shape[0] // sh.size
    return arr[sh.rank * per:(sh.rank + 1) * per]


def _host(obj):
    """A dataclass of arrays or tensors with every tensor as numpy."""
    return dataclasses.replace(obj, **{
        f.name: _np(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _row_owned(m: int, sh: Shard) -> np.ndarray:
    """Bool [m]: the rows this rank writes of row-indexed work: its share
    where m divides the ranks, else every row on rank 0 (the reference's
    ``_row_put`` rule)."""
    own = np.zeros(m, bool)
    if m % sh.size == 0:
        lo, hi = sh.span(m)
        own[lo:hi] = True
    elif sh.lead:
        own[:] = True
    return own


def _row_put(A, mesh, dtype):
    """A dense [m, n] A on this rank's device: split by rows where m divides
    the ranks, else replicated (``cosmo_tpu.parallel.mesh._row_put``)."""
    sh, device = mesh_shard(mesh), mesh_device(mesh)
    A = _np(A)
    m = A.shape[0]
    if m % sh.size:
        return torch.as_tensor(A, dtype=dtype, device=device)
    lo, hi = sh.span(m)
    return linops.RowShard(m=m, n=A.shape[1], lo=lo, shard=sh,
                           local=torch.as_tensor(A[lo:hi], dtype=dtype, device=device))


def shard_cones(mesh, cones, dtype=torch.float64, axis: str = BLOCK_AXIS):
    """The cone data on this rank's device with this rank's slices of the
    stacks (the layout of ``cosmo_tpu.parallel.mesh.shard_cones``).
    ``cones``: the unsharded ConeData, numpy (``compile_cones``) or on a
    device. Batches that do not divide the ranks are padded with dump-slot
    blocks (gather the zero dump entry with scale 0, scatter back to the
    dump slot), exact no-ops. Sets :data:`LAST_SHARD_REPORT`."""
    global LAST_SHARD_REPORT

    sh, device = mesh_shard(mesh), mesh_device(mesh)
    d = sh.size
    DUMP = cones.m
    cones = _host(cones)
    LAST_SHARD_REPORT = psd_cost_report(cones, d)

    def stack(arr, fill):
        return _mine(_pad_batch(_np(arr), d, fill), sh)

    soc = tuple(dataclasses.replace(b, idx=stack(b.idx, DUMP))
                for b in cones.soc_buckets)

    def shard_psd(bkt):
        bkt = _host(bkt)
        B = int(bkt.gather_idx.shape[0])
        if B < d:
            # fewer blocks than ranks: batch sharding would run n_dev-fold
            # dummy work (a [1, 896] clique padded to 8 blocks); keep the
            # batch on every rank and split the polar's products over the
            # matrix rows instead
            return dataclasses.replace(bkt, split=sh)
        # the fast path survives when the batch divides the ranks (the
        # compact transform pads block counts to a multiple of the mesh
        # size, so this holds for every decomposed solve); dump-block
        # padding breaks its contiguous rows, so an uneven bucket falls
        # back to the index maps, which encode the dump no-ops
        if bkt.fastpath != "none" and B % d == 0:
            per = B // d
            return dataclasses.replace(
                bkt, gather_idx=_mine(bkt.gather_idx, sh),
                gather_scale=_mine(bkt.gather_scale, sh),
                scatter_idx=_mine(bkt.scatter_idx, sh),
                scatter_scale=_mine(bkt.scatter_scale, sh),
                contig_start=bkt.contig_start + sh.rank * per * bkt.tri_len)
        return dataclasses.replace(
            bkt, gather_idx=stack(bkt.gather_idx, DUMP),
            gather_scale=stack(bkt.gather_scale, 0),
            scatter_idx=stack(bkt.scatter_idx, DUMP),
            scatter_scale=stack(bkt.scatter_scale, 0),
            fastpath="none", contig_start=-1, tri_len=0, expand=None,
            compress=None, sh_starts=None, sh_scale=None, sh_flat=None,
            sh_csc=None, cp_csc=None, sh_idx=None, sym_scale=None)

    exp = cones.exp and dataclasses.replace(
        cones.exp, idx=stack(cones.exp.idx, DUMP),
        is_dual=stack(cones.exp.is_dual, False), tol=stack(cones.exp.tol, 1e-8))
    pw = cones.pow and dataclasses.replace(
        cones.pow, idx=stack(cones.pow.idx, DUMP),
        alpha=stack(cones.pow.alpha, 0.5), is_dual=stack(cones.pow.is_dual, False),
        tol=stack(cones.pow.tol, 1e-8))
    elementwise = (_np(cones.eq_mask) | _np(cones.nonneg_mask) | _np(cones.box_mask))
    out = dataclasses.replace(
        cones, soc_buckets=soc, psd_buckets=tuple(shard_psd(b) for b in cones.psd_buckets),
        exp=exp, pow=pw, own_rows=elementwise & _row_owned(cones.m, sh))
    return dataclasses.replace(conedata.to_device(out, device, dtype), shard=sh)


def _align_bounds(key, d: int):
    """Chunk boundaries for :func:`_align_triplets`: ``d`` near-equal nnz
    chunks snapped down to segment starts of ``key``, plus the padded
    per-chunk length ``L``."""
    nnz = key.shape[0]
    change = np.flatnonzero(np.diff(key)) + 1          # positions where key changes
    bounds = [0]
    for k in range(1, d):
        ideal = k * nnz // d
        # largest segment start <= ideal (0 if none)
        i = np.searchsorted(change, ideal, side="right") - 1
        snap = int(change[i]) if i >= 0 else 0
        bounds.append(max(snap, bounds[-1]))
    bounds.append(nnz)
    L = max(bounds[i + 1] - bounds[i] for i in range(d))
    return bounds, L


def coo_shard_remap(A, d: int):
    """Index map from the unsharded row-sorted nnz layout of ``A`` (a
    ``Coo``) to the padded layout of :func:`shard_coo`: ``new_pos[j]`` is
    where original triplet ``j`` lands. The block KKT's pair lists are
    remapped through it (:func:`shard_blockkkt`)."""
    key = _np(A.rows)
    nnz = key.shape[0]
    if nnz == 0:
        return np.zeros(0, np.int64)
    bounds, L = _align_bounds(key, d)
    new_pos = np.empty(nnz, np.int64)
    for i in range(d):
        s, e = bounds[i], bounds[i + 1]
        new_pos[s:e] = i * L + np.arange(e - s, dtype=np.int64)
    return new_pos


def _align_triplets(key, other, vals, d: int):
    """Pad sorted COO triplets so each of the ``d`` equal nnz chunks covers
    only whole segments of ``key`` (rows for the row-sorted copy, columns
    for the column-sorted one). Every output entry of a segment-sum product
    is then computed entirely on one rank and the others contribute exact
    zeros, so the reassembling sum is bit-exact in any order. Fillers
    repeat the chunk's last key with value 0, keeping the order."""
    nnz = key.shape[0]
    if nnz == 0:
        return key, other, vals
    bounds, L = _align_bounds(key, d)
    ko = np.empty(d * L, key.dtype)
    oo = np.zeros(d * L, other.dtype)
    vo = np.zeros(d * L, vals.dtype)
    for i in range(d):
        s, e = bounds[i], bounds[i + 1]
        n_i = e - s
        ko[i * L: i * L + n_i] = key[s:e]
        oo[i * L: i * L + n_i] = other[s:e]
        vo[i * L: i * L + n_i] = vals[s:e]
        fill_key = key[e - 1] if n_i > 0 else (key[s - 1] if s > 0 else 0)
        ko[i * L + n_i: (i + 1) * L] = fill_key
    return ko, oo, vo


def _local_ptr(ptr, sh: Shard, L: int):
    """Global segment pointers of a padded layout as pointers into this
    rank's chunk of length ``L`` (segments of other chunks are empty)."""
    return np.clip(ptr.astype(np.int64) - sh.rank * L, 0, L)


def shard_coo(mesh, A, dtype=None, axis: str = BLOCK_AXIS):
    """This rank's chunk of a ``Coo`` (numpy or on a device) on its device:
    both sorted copies padded by :func:`_align_triplets` and split along
    the nnz, with the segment pointers rebuilt for the padded layout and
    cut to the chunk (the fillers are exact-zero segment entries). Products
    through it sum in a fixed order and end in one sum (``ops/linops.py``)."""
    sh, device = mesh_shard(mesh), mesh_device(mesh)
    d = sh.size
    if dtype is None:
        dtype = A.vals.dtype if isinstance(A.vals, torch.Tensor) else torch.float64
    r, c, v = _align_triplets(_np(A.rows), _np(A.cols), _np(A.vals), d)
    cc, cr, cv = _align_triplets(_np(A.ccols), _np(A.crows), _np(A.cvals), d)
    row_ptr, w_r = linops.segment_ptr(r, A.m)
    col_ptr, w_c = linops.segment_ptr(cc, A.n)
    L, Lc = r.shape[0] // d, cc.shape[0] // d

    def chunk(a, n):
        return a[sh.rank * n:(sh.rank + 1) * n]

    local = linops.Coo(
        m=A.m, n=A.n, rows=chunk(r, L), cols=chunk(c, L), vals=chunk(v, L),
        crows=chunk(cr, Lc), ccols=chunk(cc, Lc), cvals=chunk(cv, Lc),
        row_ptr=_local_ptr(row_ptr, sh, L), col_ptr=_local_ptr(col_ptr, sh, Lc),
        max_row_nnz=w_r, max_col_nnz=w_c)
    return dataclasses.replace(linops.coo_to_device(local, device, dtype), shard=sh,
                               fixed_order=True)


def shard_problem(mesh, P_mat, A, q, b, cones, dtype=None, axis: str = BLOCK_AXIS):
    """The problem data on this rank's device: ``A`` split (a ``Coo`` along
    its nnz, :func:`shard_coo`; a dense A by rows, ``_row_put``), ``P``,
    ``q`` and ``b`` replicated (a ``Coo`` P sums its segments in a fixed
    order, so every rank gets the same bits), the cone stacks split
    (:func:`shard_cones`). ``dtype``: the solve's float type (default:
    ``q``'s when it is a tensor, else float64)."""
    device = mesh_device(mesh)
    if dtype is None:
        dtype = q.dtype if isinstance(q, torch.Tensor) else torch.float64
    if isinstance(A, linops.Coo):
        A_s = shard_coo(mesh, A, dtype, axis)
    else:
        A_s = _row_put(A, mesh, dtype)
    if isinstance(P_mat, linops.Coo):
        P_s = dataclasses.replace(linops.coo_to_device(_host(P_mat), device, dtype),
                                  fixed_order=True)
    else:
        P_s = torch.as_tensor(_np(P_mat), dtype=dtype, device=device)
    return (P_s, A_s, _rep(q, device, dtype), _rep(b, device, dtype),
            shard_cones(mesh, cones, dtype, axis))


def _rep(x, device, dtype):
    return torch.as_tensor(_np(x), dtype=dtype, device=device)


def shard_blockkkt(mesh, meta, A, axis: str = BLOCK_AXIS):
    """The block KKT's structure split over the ranks, on this rank's
    device (``cosmo_tpu.parallel.mesh.shard_blockkkt``). ``meta``: the
    host ``BlockKKTMeta`` of :func:`~cosmo_tpu_torch.ops.blockkkt.analyze`;
    ``A``: the unsharded ``Coo`` it was analyzed against. Each bucket's
    components are padded to a multiple of the ranks with identity blocks
    (member columns ``n``: a unit diagonal and an exact-zero apply) and
    split: a rank keeps its own components and the pairs that land in
    them, with their targets local, so it assembles, factors and applies
    only those, and one sum reassembles x. The pairs' nnz indices into A's
    row-sorted values are remapped through :func:`coo_shard_remap` into
    the padded layout of :func:`shard_coo`, which the solve gathers once
    (``linops.full_vals``). The block-dense A is dropped, so the solve runs
    ``blockkkt.solve`` without the block-space x carry."""
    sh, device = mesh_shard(mesh), mesh_device(mesh)
    d = sh.size
    remap = coo_shard_remap(A, d)
    buckets = []
    for b in meta.buckets:
        b = _host(b)
        cols = _pad_batch(b.cols, d, meta.n)
        per = cols.shape[0] // d
        lo, hi = sh.rank * per * b.k * b.k, (sh.rank + 1) * per * b.k * b.k
        a_in = (b.a_tgt >= lo) & (b.a_tgt < hi)
        p_in = (b.p_tgt >= lo) & (b.p_tgt < hi)
        a_tgt, p_tgt = b.a_tgt[a_in] - lo, b.p_tgt[p_in] - lo
        buckets.append(dataclasses.replace(
            b, N=per, cols=_mine(cols, sh), a_rows=b.a_rows[a_in],
            a_pi=remap[np.asarray(b.a_pi[a_in], np.int64)],
            a_pj=remap[np.asarray(b.a_pj[a_in], np.int64)], a_tgt=a_tgt,
            p_idx=b.p_idx[p_in], p_tgt=p_tgt,
            **blockkkt.target_stream(a_tgt, p_tgt),
            R=0, row_ids=None, av_idx=None, av_tgt=None))
    meta = dataclasses.replace(meta, buckets=tuple(buckets))
    return dataclasses.replace(blockkkt.meta_to_device(meta, device), shard=sh)


def shard_vectors(mesh, x0, s0, mu0, dtype=None, axis: str = BLOCK_AXIS):
    """Warm-start vectors on this rank's device, replicated as every
    vector of the ADMM loop is (:func:`shard_problem`)."""
    device = mesh_device(mesh)
    if dtype is None:
        dtype = x0.dtype if isinstance(x0, torch.Tensor) else torch.float64
    return tuple(_rep(v, device, dtype) for v in (x0, s0, mu0))
