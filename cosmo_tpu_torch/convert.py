"""Carry a compiled problem from the JAX package into this one.

A solver has no weights: its state is the compiled cone data, the
block-dense constraint matrix and the settings. These functions take them
as plain dicts of numpy arrays and Python scalars — the dataclass fields of
a ``cosmo_tpu`` ``ConeData`` (with its ``SocBucket``/``PsdBucket`` tuples as
lists of dicts), of a ``Bde``, and of a ``Settings`` — so both packages can
be run on identical structures without this package importing JAX.
"""
from __future__ import annotations

import dataclasses

import torch

from .ops import conedata, linops
from .ops.conedata import not_ported
from .settings import Settings


def _pick(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def cones_from_dict(d: dict, device, dtype: torch.dtype) -> conedata.ConeData:
    """A ``cosmo_tpu.ops.conedata.ConeData`` as a dict -> this package's
    ConeData on ``device`` (floats in ``dtype``)."""
    for key in ("exp", "pow"):
        part = d.get(key)
        if part is not None and len(part["idx"]) > 0:
            raise not_ported(f"{key} cones", "exp/pow/custom/complex cones")
    if d.get("custom"):
        raise not_ported("custom cones", "exp/pow/custom/complex cones")
    psd = []
    for b in d.get("psd_buckets", ()):
        if b.get("fastpath", "none") not in ("none", "matmul"):
            raise not_ported(f"the {b['fastpath']} PSD layout",
                             "shear and colpad layouts")
        psd.append(conedata.PsdBucket(**_pick(conedata.PsdBucket, b)))
    soc = [conedata.SocBucket(idx=b["idx"]) for b in d.get("soc_buckets", ())]
    top = _pick(conedata.ConeData, d)
    top.update(soc_buckets=tuple(soc), psd_buckets=tuple(psd))
    return conedata.to_device(conedata.ConeData(**top), device, dtype)


def bde_from_dict(d: dict, device, dtype: torch.dtype) -> linops.Bde:
    """A ``cosmo_tpu.ops.linops.Bde`` as a dict -> this package's Bde on
    ``device``."""
    return linops.bde_to_device(linops.Bde(**_pick(linops.Bde, d)), device, dtype)


def settings_from_dict(d: dict) -> Settings:
    """``dataclasses.asdict`` of a ``cosmo_tpu.Settings`` -> Settings."""
    return Settings.from_dict(d)
