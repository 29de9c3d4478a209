"""Chordal decomposition of sparse PSD constraints (host side, numpy): a
copy of ``cosmo_tpu.chordal``, which imports no JAX, kept in this package
so that it imports nothing of ``cosmo_tpu``. With a pad ladder, the
compact transform lays a clique block whose padded side is ``colpad_min``
or more out column-padded (all k^2 entries, ``transform.py``; the cone
``models.cones.PsdConeTriangleColPad``), which the colpad PSD layout
projects."""
from .decompose import decompose, reverse
from .merging import CliqueGraphMerge, MergeStrategy, finish_graph_merge
from .transform import ChordalInfo, SparsityPattern

__all__ = [
    "decompose", "reverse", "ChordalInfo", "SparsityPattern",
    "MergeStrategy", "CliqueGraphMerge", "finish_graph_merge",
]
