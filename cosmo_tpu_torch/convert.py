"""Carry a compiled problem from the JAX package into this one.

A solver has no weights: its state is the compiled cone data, the
constraint matrix, the chordal decomposition, the block KKT's structure
and the settings. These functions take them as plain dicts of numpy arrays,
scipy matrices and Python scalars — the dataclass fields of a ``cosmo_tpu``
``ConeData`` (with its ``SocBucket``/``PsdBucket`` tuples as lists of
dicts), ``Bde``, ``ChordalInfo``, ``BlockKKTMeta`` and ``Settings``, and a
cone as the dict of its dataclass fields plus ``"type"``, its class name —
so both packages can be run on identical structures without this package
importing JAX.
"""
from __future__ import annotations

import dataclasses

import torch

from .chordal import transform, trees
from .models import cones as C
from .ops import blockkkt, conedata, linops
from .settings import Settings


def _pick(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def cones_from_dict(d: dict, device, dtype: torch.dtype) -> conedata.ConeData:
    """A ``cosmo_tpu.ops.conedata.ConeData`` as a dict -> this package's
    ConeData on ``device`` (floats in ``dtype``). Its ``"custom"`` entries
    are ``(offset, cone)`` pairs whose cone is this package's
    :class:`~cosmo_tpu_torch.models.cones.CustomCone` or a dict of its
    fields: the user functions must take and return torch tensors."""
    # the shear and colpad buckets also get the port's derived maps
    psd = [conedata.layout_maps(conedata.PsdBucket(**_pick(conedata.PsdBucket, b)))
           for b in d.get("psd_buckets", ())]
    soc = [conedata.SocBucket(idx=b["idx"]) for b in d.get("soc_buckets", ())]
    top = _pick(conedata.ConeData, d)
    top.update(soc_buckets=tuple(soc), psd_buckets=tuple(psd))
    for key, cls in (("exp", conedata.ExpCones), ("pow", conedata.PowCones)):
        if d.get(key) is not None:
            top[key] = cls(**_pick(cls, d[key]))
    top["custom"] = tuple(
        (int(o), c if isinstance(c, C.CustomCone) else C.CustomCone(**_pick(C.CustomCone, c)))
        for (o, c) in d.get("custom", ()))
    return conedata.to_device(conedata.ConeData(**top), device, dtype)


def bde_from_dict(d: dict, device, dtype: torch.dtype) -> linops.Bde:
    """A ``cosmo_tpu.ops.linops.Bde`` as a dict -> this package's Bde on
    ``device``."""
    return linops.bde_to_device(linops.Bde(**_pick(linops.Bde, d)), device, dtype)


def settings_from_dict(d: dict) -> Settings:
    """``dataclasses.asdict`` of a ``cosmo_tpu.Settings`` -> Settings."""
    return Settings.from_dict(d)


def cone_from_dict(d: dict) -> C.ConvexSet:
    """A cone as ``{"type": class name, **dataclass fields}`` -> this
    package's cone of that class."""
    cls = getattr(C, d["type"])
    return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                  if f.init and f.name in d})


def chordal_info_from_dict(d: dict) -> transform.ChordalInfo:
    """A ``cosmo_tpu.chordal.ChordalInfo`` as a dict (its ``problem`` a
    tuple ``(P, q, A, b, sets)``, its patterns' trees as dicts) -> this
    package's ChordalInfo."""
    P, q, A, b, sets = d["problem"]
    patterns = []
    for p in d["patterns"]:
        tree = dict(p["tree"])
        tree["merge_log"] = trees.MergeLog(**tree["merge_log"])
        patterns.append(transform.SparsityPattern(
            tree=trees.CliqueTree(**tree),
            **{k: v for k, v in p.items() if k != "tree"}))
    top = _pick(transform.ChordalInfo, d)
    top.update(problem=(P, q, A, b, [cone_from_dict(s) for s in sets]),
               sets_orig=[cone_from_dict(s) for s in d["sets_orig"]],
               patterns=patterns)
    return transform.ChordalInfo(**top)


def blockkkt_meta_from_dict(d: dict, device) -> blockkkt.BlockKKTMeta:
    """A ``cosmo_tpu.ops.blockkkt.BlockKKTMeta`` as a dict -> this
    package's BlockKKTMeta on ``device``, unsharded: its mesh ``spec`` is
    dropped (``parallel.shard_blockkkt`` shards a meta)."""
    buckets = tuple(blockkkt.BlockBucket(**_pick(blockkkt.BlockBucket, b))
                    for b in d["buckets"])
    return blockkkt.meta_to_device(
        blockkkt.BlockKKTMeta(n=int(d["n"]), buckets=buckets), device)


def coo_from_dict(d: dict, device, dtype: torch.dtype) -> linops.Coo:
    """A ``cosmo_tpu.ops.linops.Coo`` as a dict -> this package's Coo on
    ``device``."""
    return linops.coo_to_device(linops.Coo(**_pick(linops.Coo, d)), device, dtype)
