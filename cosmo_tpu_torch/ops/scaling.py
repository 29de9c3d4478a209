"""Ruiz equilibration on the device (the port of ``cosmo_tpu.ops.scaling``;
reference: src/scaling.jl:21-116). Non-separable cones are rectified to one
scalar scaling per cone (scaling.jl:129-142) with a segment mean over the
precomputed cone-row segments."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import linops
from .conedata import ConeData


class ScaleMats(NamedTuple):
    """Diagonal scaling state (reference ScaleMatrices, src/types.jl)."""

    D: torch.Tensor      # [n]
    E: torch.Tensor      # [m]
    c: torch.Tensor      # 0-d cost scaling
    Dinv: torch.Tensor
    Einv: torch.Tensor
    cinv: torch.Tensor


def identity_scale(m: int, n: int, dtype, device) -> ScaleMats:
    one = torch.ones((), dtype=dtype, device=device)
    return ScaleMats(
        D=torch.ones(n, dtype=dtype, device=device),
        E=torch.ones(m, dtype=dtype, device=device), c=one,
        Dinv=torch.ones(n, dtype=dtype, device=device),
        Einv=torch.ones(m, dtype=dtype, device=device), cinv=one,
    )


def _limit_scaling(s, dyn):
    """clip(s, MIN_SCALING, MAX_SCALING) with values below MIN mapped to 1,
    so zero norms don't blow up (reference: scaling.jl:10-18)."""
    return torch.where(s < dyn.min_scaling, torch.ones_like(s),
                       torch.minimum(s, dyn.max_scaling))


def ruiz_scale(P, A, q, b, cones: ConeData, iters: int, dyn,
               graph: "RuizGraph | None" = None):
    """Equilibrate (P, q, A, b); returns the scaled data, the scaled cone
    bounds and the ScaleMats. ``graph``: a :class:`RuizGraph` that runs the
    equilibration where it takes the operands (:meth:`RuizGraph.takes`),
    else it runs eagerly."""
    if graph is not None and graph.takes(P, A, q):
        return graph.run(P, A, q, b, cones, iters, dyn)
    return _ruiz(P, A, q, b, cones, iters, dyn)


class _Limits(NamedTuple):
    """The two scaling bounds :func:`_limit_scaling` reads."""

    min_scaling: torch.Tensor
    max_scaling: torch.Tensor


class RuizGraph:
    """:func:`ruiz_scale` of a dense P and A on a CUDA device as a CUDA
    graph, kept across the solves of one problem. The equilibration is some
    40 operations an iteration, each a launch the host issues; the first
    call captures them on static copies of q, b and the two scaling bounds,
    and a later call with the same P, A, cones and iteration count copies
    its q, b and bounds in and replays them as one launch. The replayed
    operations are the eager ones, on the same values. The outputs are the
    graph's own buffers: they hold until the next call, so a solver keeps
    one for the solves of one problem, one at a time."""

    def __init__(self):
        self.key = None

    @staticmethod
    def takes(P, A, q) -> bool:
        return q.is_cuda and type(P) is torch.Tensor and type(A) is torch.Tensor

    def _capture(self, key, P, A, q, b, cones, iters, dyn):
        self.key, self.refs = key, (P, A, cones)    # keep the captured alive
        self.q, self.b = q.clone(), b.clone()
        self.lim = _Limits(dyn.min_scaling.clone(), dyn.max_scaling.clone())
        # a warm-up outside the capture (allocator and library state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _ruiz(P, A, self.q, self.b, cones, iters, self.lim)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _ruiz(P, A, self.q, self.b, cones, iters, self.lim)

    def run(self, P, A, q, b, cones, iters: int, dyn):
        key = (id(P), id(A), id(cones), iters, q.dtype, q.shape[0], b.shape[0])
        if key != self.key:
            self._capture(key, P, A, q, b, cones, iters, dyn)
        self.q.copy_(q)
        self.b.copy_(b)
        self.lim.min_scaling.copy_(dyn.min_scaling)
        self.lim.max_scaling.copy_(dyn.max_scaling)
        self.graph.replay()
        return self.out


def _ruiz(P, A, q, b, cones: ConeData, iters: int, dyn):
    """The equilibration of :func:`ruiz_scale`, eagerly."""
    n = q.shape[0]
    m = b.shape[0]
    D = torch.ones_like(q)
    E = torch.ones_like(b)
    c = torch.ones((), dtype=q.dtype, device=q.device)
    for _ in range(iters):
        # KKT column norms (reference: scaling.jl:3-8)
        d_norm = torch.maximum(linops.colmax_abs(P), linops.colmax_abs(A))
        e_norm = linops.rowmax_abs(A)
        dw = 1.0 / torch.sqrt(_limit_scaling(d_norm, dyn))
        ew = 1.0 / torch.sqrt(_limit_scaling(e_norm, dyn))

        P = linops.scale_rows_cols(P, dw, dw)
        A = linops.scale_rows_cols(A, ew, dw)
        q = dw * q
        b = ew * b
        D = D * dw
        E = E * ew

        # cost scaling (reference: scaling.jl:66-83)
        mean_col_norm_P = linops.colmax_abs(P).mean()
        inf_norm_q = q.abs().max() if n > 0 else q.new_zeros(())
        do_cost = (mean_col_norm_P != 0.0) & (inf_norm_q != 0.0)
        scale_cost = _limit_scaling(
            torch.maximum(_limit_scaling(inf_norm_q, dyn), mean_col_norm_P), dyn
        )
        ctmp = torch.where(do_cost, 1.0 / scale_cost, torch.ones_like(scale_cost))
        P = linops.scale_all(P, ctmp)
        q = q * ctmp
        c = c * ctmp

    # rectify cones that only admit scalar scaling (scaling.jl:87-97)
    if cones.n_rect_segments > 0:
        nseg = cones.n_rect_segments + 1  # + dump segment
        seg_sum = E.new_zeros(nseg).index_add_(
            0, cones.rect_seg, torch.where(cones.rect_mask, E, torch.zeros_like(E)))
        seg_cnt = E.new_zeros(nseg).index_add_(
            0, cones.rect_seg, cones.rect_mask.to(E.dtype))
        seg_mean = seg_sum / torch.clamp(seg_cnt, min=1.0)
        ework = torch.where(cones.rect_mask, seg_mean[cones.rect_seg] / E,
                            torch.ones_like(E))
        A = linops.scale_rows(A, ework)
        b = ework * b
        E = E * ework

    P = linops.symmetrize(P)  # reference: scaling.jl:99

    # scaled set bounds (Box rows; 0 and +/-inf rows are invariant)
    lb = cones.lb * E
    ub = cones.ub * E

    sm = ScaleMats(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
    return P, A, q, b, lb, ub, sm


def scale_variables(x, mu, s, sm: ScaleMats):
    """Move warm-started variables into scaled space (scaling.jl:118-123)."""
    return sm.Dinv * x, sm.c * (sm.Einv * mu), sm.E * s


def unscale_variables(x, mu, s, sm: ScaleMats):
    """reverse_scaling! (reference: scaling.jl:170-179)."""
    return sm.D * x, sm.cinv * (sm.E * mu), sm.Einv * s
