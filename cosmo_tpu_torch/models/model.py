"""Native modeling API: Model / assemble / set / warm starts / optimize (the
port of ``cosmo_tpu.models.model``; reference: src/interface.jl).

This layer prepares numpy data on the host — constraint merging, canonical
set ordering, the ``A <- -A`` sign flip that turns ``Ax + b in K`` into
``Ax + s = b, s in K``, the chordal decomposition of sparse PSD cones and
the block-diagonal KKT's structure analysis — moves it to the model's torch
device and unpacks the solver's result, reversing the decomposition. A
``Model`` runs on ``cuda`` unless it is given ``device="cpu"``.

The host structures are cached across ``optimize()`` calls on the same
data, as in ``cosmo_tpu``: the decomposition by its settings
(``decomp_key``), the block KKT's analysis, and the device copies of the
operators, cones and vectors by the solve's structure (``struct_key``).
``set``/``assemble`` drop them.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp
import torch

from .. import chordal
from .. import results as results_mod
from .. import solver as solver_mod
from ..ops import blockkkt, conedata, jacobi_proj
from ..ops import linops
from ..ops.conedata import not_ported
from ..settings import KKT_BLOCK, KKT_DENSE, Settings, split_settings, torch_dtype
from . import cones as C
from .constraint import Constraint


# the PSD cones a decomposed problem's blocks come in
_PSD_BLOCKS = (C.PsdCone, C.PsdConeTriangle, C.PsdConeTriangleColPad)


def _to_dense(M) -> np.ndarray:
    if sp.issparse(M):
        return np.asarray(M.todense())
    return np.asarray(M)


def _default_dtype(settings: Settings, device: torch.device) -> torch.dtype:
    """``Settings.dtype`` or, when None, float32 on a CUDA device and
    float64 on the CPU."""
    if settings.dtype is not None:
        return torch_dtype(settings.dtype)
    return torch.float32 if device.type == "cuda" else torch.float64


class Model:
    """Problem container and solve orchestration (reference Workspace/Model,
    src/types.jl:348-403). ``device``: where the solve runs; None means
    ``torch.device("cuda")``, and ``optimize`` raises when CUDA is not
    available."""

    def __init__(self, settings: Optional[Settings] = None, device=None):
        self.settings = settings if settings is not None else Settings()
        self.device = torch.device("cuda" if device is None else device)
        self.empty()

    # -- state ---------------------------------------------------------
    def empty(self):
        """Reset the model (reference: interface.jl:98-114)."""
        self.P = self.q = self.A = self.b = None
        self.sets: List[C.ConvexSet] = []
        self.is_assembled = False
        self._drop_caches()
        # what the last solve ran with, for introspection and tests
        self.last_solve: dict = {}

    def _drop_caches(self):
        self._chordal_info = None
        self._decomp_key = None
        self._blockkkt_cache = None
        self._dev_cache = None

    # -- assembly ------------------------------------------------------
    def assemble(self, P, q, constraints: Union[Constraint, Sequence[Constraint]],
                 settings: Optional[Settings] = None):
        """Build the stacked problem (reference: interface.jl:30-77)."""
        if isinstance(constraints, Constraint):
            constraints = [constraints]
        constraints = list(constraints)
        if settings is not None:
            self.settings = settings

        q = np.asarray(q, dtype=np.float64).ravel()
        n = q.shape[0]
        if not sp.issparse(P):
            P = _to_dense(P).astype(np.float64)
            if P.ndim == 0:
                P = P.reshape(1, 1)
            if P.ndim == 1:
                P = np.diag(P) if P.shape[0] == q.shape[0] else P.reshape(1, 1)
        if P.shape != (n, n):
            raise ValueError("The dimensions of matrix P and vector q don't match.")

        constraints = _merge_constraints(constraints)
        # canonical ordering (interface.jl:55, :466-475); stable sort
        constraints.sort(key=lambda c: C.sort_key(c.convex_set))

        m = sum(c.dim for c in constraints)
        for con in constraints:
            if con.A.shape[1] != n:
                raise ValueError(
                    f"A constraint has {con.A.shape[1]} columns but the problem has n={n}."
                )
        b = np.concatenate([con.b for con in constraints]) if m else np.zeros(0)
        # sign flip: Ax + b in K  ->  (-A)x + s = b (interface.jl:478-484)
        if any(sp.issparse(c.A) for c in constraints):
            A = -sp.vstack([sp.csr_matrix(con.A) for con in constraints], format="csr")
        else:
            A = np.zeros((m, n), dtype=np.float64)
            row = 0
            for con in constraints:
                A[row: row + con.dim, :] = -_to_dense(con.A)
                row += con.dim
        return self._store(P, q, A, b, [con.convex_set for con in constraints])

    def set(self, P, q, A, b, sets: Sequence[C.ConvexSet],
            settings: Optional[Settings] = None):
        """Raw-data entry: the problem is already in ``Ax + s = b`` form
        (reference: interface.jl:218-250). scipy sparse P/A stay sparse."""
        if settings is not None:
            self.settings = settings
        P = P if sp.issparse(P) else _to_dense(P).astype(np.float64)
        q = np.asarray(q, dtype=np.float64).ravel()
        A = A if sp.issparse(A) else _to_dense(A).astype(np.float64)
        b = np.asarray(b, dtype=np.float64).ravel()
        m, n = A.shape
        if len(q) != n or len(b) != m or P.shape != (n, n):
            raise ValueError("Inconsistent problem dimensions.")
        if sum(s.dim for s in sets) != m:
            raise ValueError("Cone dimensions don't sum to the number of rows of A.")
        return self._store(P, q, A, b, list(sets))

    def _store(self, P, q, A, b, sets):
        self.P, self.q, self.A, self.b, self.sets = P, q, A, b, sets
        self.is_assembled = True
        self._drop_caches()
        return self

    # -- solve -----------------------------------------------------------
    def _check_supported(self, settings: Settings, mesh):
        if mesh is not None:
            raise not_ported("optimize(mesh=...)", "mesh")
        if not isinstance(settings.kkt_solver, str) or settings.kkt_solver not in (
                KKT_DENSE, KKT_BLOCK):
            raise not_ported(f"kkt_solver={settings.kkt_solver!r}",
                             "Coo + CG" if settings.kkt_solver in ("cg", "minres")
                             else "custom KKT solvers")
        if settings.adaptive_rho and settings.adaptive_rho_interval == 0:
            raise not_ported("adaptive_rho_interval == 0 (the auto probe)",
                             "time limit and chunking")

    def _device_operators(self, P, A, sets, use_sparse, kkt_block, settings, dtype):
        """(P, A) on the device: dense tensors; both as
        :class:`~cosmo_tpu_torch.ops.linops.Coo` for sparse input that takes
        the block-diagonal KKT; or a dense P and a block-dense
        :class:`~cosmo_tpu_torch.ops.linops.Bde` A for sparse input whose
        rows come in uniform per-cone blocks."""
        n = A.shape[1]
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        if not use_sparse:
            return (torch.as_tensor(_to_dense(P), dtype=dtype, device=self.device),
                    torch.as_tensor(_to_dense(A), dtype=dtype, device=self.device))
        if kkt_block is not None:
            return tuple(linops.coo_to_device(
                linops.coo_from_scipy(sp.csr_matrix(M), np_dtype), self.device, dtype)
                for M in (P, A))
        bde = None
        dims = {s.dim for s in sets}
        if n <= 2048 and len(dims) == 1 and settings.kkt_solver == KKT_DENSE:
            bde = linops.bde_from_scipy(sp.csr_matrix(A), rb=dims.pop())
        if bde is None:
            raise not_ported("sparse input that neither decouples into the "
                             "block-diagonal KKT nor takes the block-dense row "
                             "layout (pass sparse=False to densify)",
                             "Coo + CG")
        return (torch.as_tensor(_to_dense(P), dtype=dtype, device=self.device),
                linops.bde_to_device(bde, self.device, dtype))

    def _decompose(self, settings):
        """(P, q, A, b, sets, chordal_info) of the problem to solve: the
        decomposed one when a decomposable PSD cone decomposes. The
        decomposition is cached by ``decomp_key``; a hit re-derives only q
        and b (reference: the States caching flags, types.jl:330-337)."""
        P, q, A, b, sets = self.P, self.q, self.A, self.b, self.sets
        if not settings.decompose or not any(
            isinstance(s, (C.PsdCone, C.PsdConeTriangle))
            and getattr(s, "decomposable", False) for s in sets
        ):
            return P, q, A, b, sets, None
        decomp_key = (settings.merge_strategy, settings.compact_transformation,
                      settings.psd_pad_to, settings.colpad_min)
        if self._chordal_info is None or self._decomp_key != decomp_key:
            info = chordal.decompose(P, q, A, b, sets, settings)
            if info is None:
                return P, q, A, b, sets, None
            self._chordal_info, self._decomp_key = info, decomp_key
        info = self._chordal_info
        q, b = info.refresh_qb(q, b)
        P, _, A, _, sets = info.problem
        return P, q, A, b, sets, info

    def _device_problem(self, settings, dtype, P, q, A, b, sets, chordal_info):
        """The device copies of the solve's structure and vectors, cached
        by ``struct_key``: dict with cones, kkt_block (device meta or None),
        Pd, Ad, qd, bd, the zero starting vectors and rho_row_scale."""
        use_sparse = settings.sparse is True or (
            settings.sparse == "auto" and (sp.issparse(A) or sp.issparse(P)))
        struct_key = (
            dtype, bool(use_sparse), self._decomp_key if chordal_info else None,
            int(settings.psd_pad_to), settings.eigh_backend,
            int(settings.jacobi_sweeps), settings.accelerator is not None,
            settings.kkt_solver, int(settings.kkt_block_max),
            float(settings.rho_overlap_scale),
        )
        cache = self._dev_cache
        if cache is not None and cache["struct_key"] == struct_key:
            return cache
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        cones = conedata.compile_cones(
            sets, dtype=np_dtype, psd_pad_to=settings.psd_pad_to,
            eigh_backend=settings.eigh_backend,
            jacobi_sweeps=settings.jacobi_sweeps,
            accel_on=settings.accelerator is not None,
            decomposed=chordal_info is not None, device=self.device,
        )
        # sparse problems whose reduced KKT system decouples take the
        # batched block-diagonal direct solve (always true for compact-
        # decomposed dual-form SDPs); the analysis is structural and is
        # cached apart from the device copies
        kkt_block = None
        if use_sparse and settings.kkt_solver in (KKT_DENSE, KKT_BLOCK):
            bk_key = (int(settings.kkt_block_max), self._decomp_key,
                      chordal_info is not None)
            if self._blockkkt_cache is None or self._blockkkt_cache[0] != bk_key:
                self._blockkkt_cache = (bk_key, blockkkt.analyze(
                    sp.csr_matrix(P), sp.csr_matrix(A),
                    max_block=int(settings.kkt_block_max)))
            kkt_block = self._blockkkt_cache[1]
        Pd, Ad = self._device_operators(P, A, sets, use_sparse, kkt_block,
                                        settings, dtype)
        m, n = A.shape

        def vec(v):
            return torch.as_tensor(v, dtype=dtype, device=self.device)

        self._dev_cache = dict(
            struct_key=struct_key,
            cones=conedata.to_device(cones, self.device, dtype),
            kkt_block=(None if kkt_block is None
                       else blockkkt.meta_to_device(kkt_block, self.device)),
            Pd=Pd, Ad=Ad, qd=vec(q), bd=vec(b),
            x0=vec(np.zeros(n)), s0=vec(np.zeros(m)), mu0=vec(np.zeros(m)),
            rho_row_scale=_rho_row_scale(settings, chordal_info, sets, m, dtype,
                                         self.device),
        )
        return self._dev_cache

    def optimize(self, mesh=None, on_iter=None) -> results_mod.Result:
        """Solve the assembled problem on the model's device. ``on_iter``:
        the solver's profiling hook (``solver.solve``)."""
        if not self.is_assembled:
            raise RuntimeError(
                "The model has to be assembled/set before optimize() can be called."
            )
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device=None) solves on CUDA, which is not "
                               "available; pass device='cpu' to solve on the CPU")
        settings = self.settings
        self._check_supported(settings, mesh)
        times = results_mod.ResultTimes()
        t_solver = time.perf_counter()

        # ---- chordal decomposition (host, reference: chordal_decomposition.jl)
        t_graph = time.perf_counter()
        P, q, A, b, sets, chordal_info = self._decompose(settings)
        times.graph_time = time.perf_counter() - t_graph

        t_setup = time.perf_counter()
        dtype = _default_dtype(settings, self.device)
        m, n = A.shape
        dev = self._device_problem(settings, dtype, P, q, A, b, sets, chordal_info)
        cones, kkt_block = dev["cones"], dev["kkt_block"]
        if kkt_block is not None:
            settings = settings.replace(kkt_solver=KKT_BLOCK)
        if settings.adaptive_rho_tolerance <= 0:
            # auto rho deadband: tight where the refactor is a cheap batched
            # op, the reference's 5.0 elsewhere
            settings = settings.replace(
                adaptive_rho_tolerance=1.5 if settings.kkt_solver == KKT_BLOCK else 5.0)
        # rho_eq-amplified rows (ZeroSet / Box l == u) or the compact
        # decomposition's overlap columns make the auto kkt_refine_steps 1
        # in float32 (the df32 endgame)
        refine_hint = any(
            isinstance(s, C.ZeroSet)
            or (isinstance(s, C.Box) and np.any(s.l == s.u))
            for s in sets
        ) or (chordal_info is not None and chordal_info.num_overlaps > 0)
        static, dyn = split_settings(settings, m, n, dtype,
                                     refine_hint=refine_hint, device=self.device)
        times.setup_time = time.perf_counter() - t_setup

        # the time limit runs from the start of optimize (reference t_solver)
        deadline = (t_solver + settings.time_limit
                    if settings.time_limit and settings.time_limit > 0 else None)
        t_iter = time.perf_counter()
        out = solver_mod.solve(dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], cones,
                               dev["x0"], dev["s0"], dev["mu0"], dyn, static,
                               kkt_block=kkt_block, rho_row_scale=dev["rho_row_scale"],
                               on_iter=on_iter, deadline=deadline)
        times.iter_time = time.perf_counter() - t_iter

        t_post = time.perf_counter()
        x, y, s = out["x"], out["y"], out["s"]
        if chordal_info is not None:
            x, y, s = chordal.reverse(chordal_info, x, y, s, settings)
        times.post_time = time.perf_counter() - t_post
        backends = tuple(b.backend or cones.eigh_backend for b in cones.psd_buckets)
        self.last_solve = dict(
            device=self.device, dtype=dtype, A_layout=type(dev["Ad"]).__name__,
            kkt_solver=settings.kkt_solver,
            chordal_blocks=(0 if chordal_info is None else sum(
                isinstance(s_, _PSD_BLOCKS) for s_ in sets)),
            eigh_backend=cones.eigh_backend, bucket_backends=backends,
            jacobi_kernel=(jacobi_proj.selected_kernel()
                           if "pallas" in backends else None),
            projections=out["projections"], iter_time=times.iter_time,
            kkt_refine_steps=static.kkt_refine_steps, accel_mem=static.accel_mem,
            n_accelerated=out["n_accelerated"], refine_iter=out["refine_iter"],
            syncs=out["syncs"], refine_syncs=out["refine_syncs"],
        )

        status = results_mod.STATUS_NAMES[int(out["status"])]
        n_updates = int(out["n_rho_adapt"]) + 1
        nr = settings.nearly_ratio
        nearly = (
            out["r_prim"] < nr * settings.eps_abs + nr * settings.eps_rel * out["max_norm_prim"]
        ) and (
            out["r_dual"] < nr * settings.eps_abs + nr * settings.eps_rel * out["max_norm_dual"]
        )
        info = results_mod.ResultInfo(
            r_prim=float(out["r_prim"]),
            r_dual=float(out["r_dual"]),
            max_norm_prim=float(out["max_norm_prim"]),
            max_norm_dual=float(out["max_norm_dual"]),
            rho_updates=out["rho_log"][: min(n_updates, solver_mod.RHO_LOG_LEN)],
            nearly_feasible=bool(nearly),
            kkt_solver_iters=0,
            res_history=_order_history(out),
        )
        times.solver_time = time.perf_counter() - t_solver
        result = results_mod.Result(
            x=x, y=y, s=s,
            obj_val=float(out["cost"]),
            iter=int(out["iter"]) + int(out["safeguarding_iter"]),
            safeguarding_iter=int(out["safeguarding_iter"]),
            status=status,
            info=info,
            times=times,
        )
        return result


def _rho_row_scale(settings, chordal_info, sets, m, dtype, device):
    """Per-clique-block rho scale of a compact decomposition
    (Settings.rho_overlap_scale, cosmo_tpu.models.model): a PSD block whose
    real rows are a fraction f overlap rows gets rho_overlap_scale ** f.
    The scale is one scalar per block, so mu stays in the normal cone.
    None when it does not apply."""
    if (settings.rho_overlap_scale == 1.0 or chordal_info is None
            or chordal_info.mode != "compact" or chordal_info.num_overlaps == 0):
        return None
    ov = np.zeros(m, bool)
    ov[np.asarray(chordal_info.ov_child_rows)] = True
    ov[np.asarray(chordal_info.ov_parent_rows)] = True
    scale = np.ones(m)
    off = 0
    for s_ in sets:
        d_ = s_.dim
        if isinstance(s_, _PSD_BLOCKS):
            # the fraction of the block's real rows: colpad storage's pad
            # slots must not dilute it
            real = (s_.side * (s_.side + 1) // 2
                    if isinstance(s_, C.PsdConeTriangleColPad) else d_)
            frac = float(ov[off:off + d_].sum()) / max(real, 1)
            if frac > 0.0:
                scale[off:off + d_] = settings.rho_overlap_scale ** frac
        off += d_
    return torch.as_tensor(scale, dtype=dtype, device=device)


def _order_history(out) -> "np.ndarray | None":
    """Chronologically ordered rows of the residual-history ring (oldest
    first); None when the ring is disabled."""
    if "res_hist" not in out:
        return None
    rows = out["res_hist"]
    H = rows.shape[0]
    hn = int(out["res_hist_n"])
    if hn <= H:
        return rows[:hn]
    k = hn % H
    return np.concatenate([rows[k:], rows[:k]])


def _merge_constraints(constraints: List[Constraint]) -> List[Constraint]:
    """Fuse all ZeroSet rows and all Nonnegatives rows into one constraint
    each (reference: interface.jl:411-462)."""
    for SetT in (C.ZeroSet, C.Nonnegatives):
        group = [c for c in constraints if type(c.convex_set) is SetT]
        if len(group) > 1:
            A = sp.vstack([sp.csr_matrix(c.A) for c in group])
            b = np.concatenate([c.b for c in group])
            merged = Constraint(A, b, SetT(A.shape[0]))
            constraints = [c for c in constraints if type(c.convex_set) is not SetT]
            constraints.append(merged)
    return constraints


# convenience aliases matching the reference's API names
def assemble(model: Model, P, q, constraints, **kwargs) -> Model:
    return model.assemble(P, q, constraints, **kwargs)


def optimize(model: Model) -> results_mod.Result:
    return model.optimize()
