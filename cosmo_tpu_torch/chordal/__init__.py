"""Chordal decomposition of sparse PSD constraints (host side, numpy): a
copy of ``cosmo_tpu.chordal``, which imports no JAX, kept in this package
so that it imports nothing of ``cosmo_tpu``. The compact transform's
column-padded layout of giant clique blocks is not ported and raises."""
from .decompose import decompose, reverse
from .merging import CliqueGraphMerge, MergeStrategy, finish_graph_merge
from .transform import ChordalInfo, SparsityPattern

__all__ = [
    "decompose", "reverse", "ChordalInfo", "SparsityPattern",
    "MergeStrategy", "CliqueGraphMerge", "finish_graph_merge",
]
