"""The collectives of a solve sharded over a process group (the device
mesh of ``cosmo_tpu_torch.parallel``).

Every rank runs the same solve on the same problem. The vectors the ADMM
loop carries are replicated: each holds the same bits on every rank. A
sharded operator (a ``Coo`` chunk, a row block of a dense A, a slice of a
cone stack, the component blocks of the block KKT) computes its part of an
output into a zero vector, and one ``all_reduce(SUM)`` reassembles the
output on every rank. Each entry comes from exactly one rank and the others
add exact zeros, so the sum is exact in any order and gives every rank the
same bits. Only ``all_reduce`` (SUM, MAX) and ``broadcast`` are used, so one
code path runs on gloo over the CPU, on gloo ranks that share a CUDA card
and on NCCL.

No sum of a mesh solve uses float atomics, whose order on a CUDA device can
change from run to run: every segment sum runs in one fixed order
(``linops._segment_sum(fixed=True)``, a ``Coo``'s ``fixed_order``), so each
replicated tensor has the same bits on every rank and in every run.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class Shard:
    """This rank's place in the group a solve is sharded over. ``calls``
    counts the collectives made through it."""

    group: Any          # torch.distributed ProcessGroup
    rank: int           # rank in ``group``
    size: int
    src: int = 0        # global rank of the group's rank 0 (broadcasts)
    calls: int = 0

    @property
    def lead(self) -> bool:
        """Whether this rank writes the rows of replicated work."""
        return self.rank == 0

    def span(self, k: int):
        """(lo, hi): this rank's share of ``k`` rows, in near-equal
        contiguous chunks."""
        return self.rank * k // self.size, (self.rank + 1) * k // self.size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        self.calls += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` maximized over the group, in place."""
        self.calls += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        self.calls += 1
        dist.broadcast(t, src=self.src, group=self.group)
        return t


def reduce_sum(shard: "Shard | None", t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ``shard`` (``t`` itself without one)."""
    return t if shard is None else shard.sum(t)


def reduce_max(shard: "Shard | None", t: torch.Tensor) -> torch.Tensor:
    """``t`` maximized over ``shard`` (``t`` itself without one)."""
    return t if shard is None else shard.max(t)


def split_rows_mm(shard: Shard, mm):
    """``mm`` (a batched product) with its output's rows split over the
    group: each rank computes its rows of ``A @ B`` and one sum reassembles
    the product on every rank (a matrix-row-sharded PSD bucket's polar
    products, ``cosmo_tpu.ops.projections:186-190``)."""
    def split(A, B):
        lo, hi = shard.span(A.shape[-2])
        out = A.new_zeros(A.shape[:-1] + B.shape[-1:])
        out[..., lo:hi, :] = mm(A[..., lo:hi, :], B)
        return shard.sum(out)

    return split
