"""Native modeling API: Model / assemble / set / set_csc / update / warm
starts / optimize (the port of ``cosmo_tpu.models.model``; reference:
src/interface.jl).

This layer prepares numpy data on the host — constraint merging, canonical
set ordering, the ``A <- -A`` sign flip that turns ``Ax + b in K`` into
``Ax + s = b, s in K``, the chordal decomposition of sparse PSD cones and
the block-diagonal KKT's structure analysis — moves it to the model's torch
device and unpacks the solver's result, reversing the decomposition. A
``Model`` runs on ``cuda`` unless it is given ``device="cpu"``.

Sparse input that neither decouples into the block-diagonal KKT nor takes
the block-dense row layout goes to the device as ``Coo`` and solves
through matrix-free CG (the reference's ``KKT_CG`` rewrite), with the
overlap preconditioner on a compact decomposition.

The host structures are cached across ``optimize()`` calls on the same
data, as in ``cosmo_tpu``: the decomposition by its settings
(``decomp_key``), the block KKT's analysis, and the device copies of the
operators and cones by the solve's structure (``struct_key``). The device
copies of q and b, and of the starting vectors, are cached apart from them
by version: ``update`` and the warm starts bump a counter, and a re-solve
moves only the vectors whose version changed. On a CUDA device the
structure's cache also keeps the scaling's CUDA graph
(``ops/scaling.RuizGraph``): the first solve captures it, a re-solve
replays it. ``set``/``assemble`` drop everything.

``optimize(mesh=make_mesh())`` solves SPMD over ``torch.distributed``
(``cosmo_tpu_torch.parallel``): every rank of the group calls it on the
same model and gets the same result. The mesh's size pads the
decomposition's block counts (``chordal.decompose(pad_batch=)``) and keys
both caches; the operators, cones and block KKT are sharded by rank
(``parallel/mesh.py``); the block-dense A layout and the CUDA graphs are
off there.
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
from ..ops import kkt as kkt_ops
from ..ops import linops
from ..ops import scaling as scaling_ops
from ..settings import (KKT_BLOCK, KKT_CG, KKT_DENSE, KKT_MINRES, Settings,
                        split_settings, torch_dtype)
from ..utils import printing
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
        self.x0 = self.s0 = self.mu0 = None
        self.is_assembled = False
        # whether the last solve ran on a chordally decomposed problem
        self.is_decomposed = False
        self._drop_caches()
        # versions of q/b and of the starting vectors: a re-solve moves only
        # the device vectors whose version changed
        self._qb_version = 0
        self._ws_version = 0
        # the interval chosen by the auto rho-adaptation probe
        # (adaptive_rho_interval == 0), for introspection
        self.auto_rho_interval: Optional[int] = None
        # what the last solve ran with, for introspection and tests
        self.last_solve: dict = {}

    def _drop_caches(self):
        self._chordal_info = None
        self._decomp_key = None
        self._blockkkt_cache = None
        self._dev_cache = None

    @property
    def model_size(self):
        """(m, n) of the stored problem, (0, 0) before one is set."""
        return self.A.shape if self.A is not None else (0, 0)

    # -- assembly ------------------------------------------------------
    def assemble(self, P, q, constraints: Union[Constraint, Sequence[Constraint]],
                 settings: Optional[Settings] = None, x0=None, y0=None, s0=None):
        """Build the stacked problem (reference: interface.jl:30-77), with an
        optional warm start (:meth:`warm_start`)."""
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
        self._store(P, q, A, b, [con.convex_set for con in constraints])
        return self.warm_start(x0, y0, s0)

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

    def set_csc(self, P_data, P_indices, P_indptr, q, A_data, A_indices, A_indptr,
                b, cone: dict, l=None, u=None, m=None, n=None, settings=None):
        """CSC-triplet entry with an SCS-style cone dict, the cosmo-python
        path (reference: interface.jl:253-309); the keys are those of
        :func:`cone_sets_from_dict`. ``settings`` may be a dict."""
        n = len(q) if n is None else n
        m = len(b) if m is None else m
        P = sp.csc_matrix((P_data, P_indices, P_indptr), shape=(n, n))
        A = sp.csc_matrix((A_data, A_indices, A_indptr), shape=(m, n))
        if isinstance(settings, dict):
            settings = Settings.from_dict(settings)
        return self.set(P, q, A, b, cone_sets_from_dict(cone, l, u), settings)

    def _store(self, P, q, A, b, sets):
        self.P, self.q, self.A, self.b, self.sets = P, q, A, b, sets
        self.is_assembled = True
        self.is_decomposed = False
        self._drop_caches()
        m, n = A.shape
        self.x0, self.s0, self.mu0 = np.zeros(n), np.zeros(m), np.zeros(m)
        self._qb_version += 1
        self._ws_version += 1
        return self

    # -- updates / warm starts ------------------------------------------
    def update(self, q=None, b=None):
        """Update q and/or b between solves (reference: interface.jl:187-211).
        It stays legal after a decomposed solve: the cached decomposition
        keeps its original-space index maps and re-derives the decomposed
        q and b."""
        if not self.is_assembled:
            raise RuntimeError("Model has to be assembled before updating q or b.")
        m, n = self.model_size
        if q is not None:
            q = np.asarray(q, dtype=np.float64).ravel()
            if len(q) != n:
                raise ValueError("The dimension of q does not agree with n.")
            self.q = q
        if b is not None:
            b = np.asarray(b, dtype=np.float64).ravel()
            if len(b) != m:
                raise ValueError("The dimension of b does not agree with m.")
            self.b = b
        self._qb_version += 1
        return self

    def warm_start_primal(self, x0, ind=None):
        """Warm start x (at ``ind``); a full x0 also warm starts s = b - A x0
        (reference: interface.jl:133-150)."""
        x0 = np.atleast_1d(np.asarray(x0, dtype=np.float64))
        if ind is None and len(x0) == self.model_size[1]:
            self.x0[:] = x0
            self.s0[:] = self.b - self.A @ x0
        else:
            self.x0[ind] = x0
        self._ws_version += 1
        return self

    def warm_start_slack(self, s0, ind=None):
        s0 = np.atleast_1d(np.asarray(s0, dtype=np.float64))
        if ind is None:
            self.s0[:] = s0
        else:
            self.s0[ind] = s0
        self._ws_version += 1
        return self

    def warm_start_dual(self, y0, ind=None):
        """Warm start y; internally mu = -y (reference: interface.jl:161-169)."""
        y0 = np.atleast_1d(np.asarray(y0, dtype=np.float64))
        if ind is None:
            self.mu0[:] = -y0
        else:
            self.mu0[ind] = -y0
        self._ws_version += 1
        return self

    def warm_start(self, x0=None, y0=None, s0=None):
        if x0 is not None:
            self.warm_start_primal(x0)
        if y0 is not None:
            self.warm_start_dual(y0)
        if s0 is not None:
            self.warm_start_slack(s0)
        return self

    # -- solve -----------------------------------------------------------
    def _enter_mesh(self, mesh):
        """This rank's Shard of ``mesh`` (None without one); the model's
        device becomes the rank's mesh device. Raises TypeError for an
        object that is not a mesh of ``parallel.make_mesh``."""
        if mesh is None:
            return None
        from ..parallel import mesh as mesh_mod

        if not mesh_mod.is_mesh(mesh):
            raise TypeError(f"mesh must be a DeviceMesh of "
                            f"cosmo_tpu_torch.parallel.make_mesh, not {type(mesh).__name__}")
        device = mesh_mod.mesh_device(mesh)
        if device.type != self.device.type:
            raise ValueError(f"a Model on {self.device.type} cannot solve over a "
                             f"{device.type} mesh")
        self.device = device
        return mesh_mod.mesh_shard(mesh)

    def _device_operators(self, P, A, sets, use_sparse, kkt_block, settings, dtype):
        """(P, A) on the device: dense tensors; a dense P and a block-dense
        :class:`~cosmo_tpu_torch.ops.linops.Bde` A for sparse input whose
        rows come in uniform per-cone blocks (dense KKT, n <= 2048); else
        both as :class:`~cosmo_tpu_torch.ops.linops.Coo` for sparse input
        (the block-diagonal KKT, or CG)."""
        n = A.shape[1]
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        if not use_sparse:
            return (torch.as_tensor(_to_dense(P), dtype=dtype, device=self.device),
                    torch.as_tensor(_to_dense(A), dtype=dtype, device=self.device))
        bde = None
        dims = {s.dim for s in sets}
        if (kkt_block is None and n <= 2048 and len(dims) == 1
                and settings.kkt_solver == KKT_DENSE):
            bde = linops.bde_from_scipy(sp.csr_matrix(A), rb=dims.pop())
        if bde is not None:
            return (torch.as_tensor(_to_dense(P), dtype=dtype, device=self.device),
                    linops.bde_to_device(bde, self.device, dtype))
        return tuple(linops.coo_to_device(
            linops.coo_from_scipy(sp.csr_matrix(M), np_dtype), self.device, dtype)
            for M in (P, A))

    def _decompose(self, settings, n_dev: int = 1):
        """(P, q, A, b, sets, chordal_info) of the problem to solve: the
        decomposed one when a decomposable PSD cone decomposes. The
        decomposition is cached by ``decomp_key``; a hit re-derives only q
        and b (reference: the States caching flags, types.jl:330-337).
        ``n_dev``: the mesh's rank count, to which the compact transform
        pads its block counts."""
        P, q, A, b, sets = self.P, self.q, self.A, self.b, self.sets
        if not settings.decompose or not any(
            isinstance(s, (C.PsdCone, C.PsdConeTriangle))
            and getattr(s, "decomposable", False) for s in sets
        ):
            return P, q, A, b, sets, None
        decomp_key = (settings.merge_strategy, settings.compact_transformation,
                      settings.psd_pad_to, settings.colpad_min, n_dev)
        if self._chordal_info is None or self._decomp_key != decomp_key:
            info = chordal.decompose(P, q, A, b, sets, settings, pad_batch=n_dev)
            if info is None:
                return P, q, A, b, sets, None
            self._chordal_info, self._decomp_key = info, decomp_key
        info = self._chordal_info
        q, b = info.refresh_qb(q, b)
        P, _, A, _, sets = info.problem
        return P, q, A, b, sets, info

    def _device_problem(self, settings, dtype, P, A, sets, chordal_info, mesh=None):
        """The device copies of the solve's structure, cached by
        ``struct_key``: dict with use_sparse, cones, kkt_block (device meta
        or None), Pd, Ad, rho_row_scale and, on a CUDA device without a
        mesh, the scaling graph that the re-solves replay;
        :meth:`_device_vectors` adds the vectors. Under ``mesh`` they are
        this rank's shards (``parallel.shard_problem``)."""
        use_sparse = settings.sparse is True or (
            settings.sparse == "auto" and (sp.issparse(A) or sp.issparse(P)))
        struct_key = (
            dtype, bool(use_sparse), self._decomp_key if chordal_info else None,
            int(settings.psd_pad_to), settings.eigh_backend,
            int(settings.jacobi_sweeps), settings.accelerator is not None,
            settings.kkt_solver, int(settings.kkt_block_max),
            float(settings.rho_overlap_scale), None if mesh is None else id(mesh),
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
        if mesh is None:
            Pd, Ad = self._device_operators(P, A, sets, use_sparse, kkt_block,
                                            settings, dtype)
            cones = conedata.to_device(cones, self.device, dtype)
            if kkt_block is not None:
                kkt_block = blockkkt.meta_to_device(kkt_block, self.device)
        else:
            from .. import parallel

            # the block-dense A is single-process only: the mesh keeps Coo
            if use_sparse:
                P, A = (linops.coo_from_scipy(sp.csr_matrix(M), np_dtype) for M in (P, A))
            if kkt_block is not None:
                # the pair lists are remapped against the unsharded layout
                kkt_block = parallel.shard_blockkkt(mesh, kkt_block, A)
            m, n = A.shape
            Pd, Ad, _, _, cones = parallel.shard_problem(
                mesh, P if use_sparse else _to_dense(P), A if use_sparse else _to_dense(A),
                np.zeros(n), np.zeros(m), cones, dtype)
        self._dev_cache = dict(
            struct_key=struct_key, use_sparse=bool(use_sparse), cones=cones,
            kkt_block=kkt_block, Pd=Pd, Ad=Ad, kkt_precond=None,
            mesh=mesh,      # held, so that the key's id(mesh) stays its own
            scale_graph=(scaling_ops.RuizGraph()
                         if self.device.type == "cuda" and mesh is None else None),
            rho_row_scale=_rho_row_scale(settings, chordal_info, sets, A.shape[0],
                                         dtype, self.device),
            qb_version=None, ws_version=None,
        )
        return self._dev_cache

    def _device_vectors(self, dev, dtype, q, b, chordal_info, mesh=None):
        """Move q/b and the starting vectors to the device when their version
        changed since the cached copies (into ``dev``); replicated under a
        mesh (``parallel.shard_vectors``)."""
        def vec(v):
            return torch.as_tensor(v, dtype=dtype, device=self.device)

        if dev["qb_version"] != self._qb_version:
            dev.update(qd=vec(q), bd=vec(b), qb_version=self._qb_version)
        if dev["ws_version"] != self._ws_version:
            # a decomposed problem starts from the warm start lifted into
            # the decomposed space (reference: interface.jl:117-179)
            starts = (self.x0, self.s0, self.mu0) if chordal_info is None else (
                chordal_info.map_warm_start(self.x0, self.s0, self.mu0))
            if mesh is None:
                starts = map(vec, starts)
            else:
                from .. import parallel

                starts = parallel.shard_vectors(mesh, *starts, dtype=dtype)
            dev.update(zip(("x0", "s0", "mu0"), starts), ws_version=self._ws_version)

    def optimize(self, mesh=None, on_iter=None) -> results_mod.Result:
        """Solve the assembled problem on the model's device. ``mesh``: a
        mesh of :func:`cosmo_tpu_torch.parallel.make_mesh`; every rank of it
        calls ``optimize`` on the same model, solves on its mesh device and
        returns the same result. ``on_iter``: the solver's profiling hook
        (``solver.solve``)."""
        if not self.is_assembled:
            raise RuntimeError(
                "The model has to be assembled/set before optimize() can be called."
            )
        shard = self._enter_mesh(mesh)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Model(device=None) solves on CUDA, which is not "
                               "available; pass device='cpu' to solve on the CPU")
        settings = self.settings
        times = results_mod.ResultTimes()
        t_solver = time.perf_counter()
        calls0 = 0 if shard is None else shard.calls

        # ---- chordal decomposition (host, reference: chordal_decomposition.jl)
        t_graph = time.perf_counter()
        P, q, A, b, sets, chordal_info = self._decompose(
            settings, 1 if shard is None else shard.size)
        self.is_decomposed = chordal_info is not None
        times.graph_time = time.perf_counter() - t_graph

        t_setup = time.perf_counter()
        dtype = _default_dtype(settings, self.device)
        m, n = A.shape
        dev = self._device_problem(settings, dtype, P, A, sets, chordal_info, mesh)
        self._device_vectors(dev, dtype, q, b, chordal_info, mesh)
        cones, kkt_block = dev["cones"], dev["kkt_block"]
        if kkt_block is not None:
            settings = settings.replace(kkt_solver=KKT_BLOCK)
        elif (dev["use_sparse"] and settings.kkt_solver in (KKT_DENSE, KKT_BLOCK)
              and not isinstance(dev["Ad"], linops.Bde)):
            # coupled sparse input: matrix-free CG (cosmo_tpu.models.model)
            settings = settings.replace(kkt_solver=KKT_CG)
        kkt_precond = None
        if (settings.kkt_overlap_precond and settings.kkt_solver == KKT_CG
                and chordal_info is not None and chordal_info.mode == "compact"
                and chordal_info.num_overlaps > 0
                and chordal_info.ov_child_rows is not None):
            # the overlap block's Sherman-Morrison preconditioner
            if dev["kkt_precond"] is None:
                dev["kkt_precond"] = kkt_ops.make_overlap_precond(
                    chordal_info.n_orig, chordal_info.ov_child_rows,
                    chordal_info.ov_parent_rows, self.device,
                    fixed_order=shard is not None)
            kkt_precond = dev["kkt_precond"]
        if settings.adaptive_rho_tolerance <= 0:
            # auto rho deadband: tight where the refactor is a cheap batched
            # op, the reference's 5.0 elsewhere
            settings = settings.replace(
                adaptive_rho_tolerance=1.5 if settings.kkt_solver == KKT_BLOCK else 5.0)
        static, dyn = split_settings(settings, m, n, dtype,
                                     refine_hint=refine_hint(sets, chordal_info),
                                     device=self.device)
        # the option set this solve ran with, after the auto resolutions
        self._resolved_settings = settings
        times.setup_time = time.perf_counter() - t_setup
        if settings.verbose:
            printing.print_header(self, m, n, sets=sets, chordal_info=chordal_info,
                                  settings=settings)

        # the time limit runs from the start of optimize (reference t_solver)
        deadline = (t_solver + settings.time_limit
                    if settings.time_limit and settings.time_limit > 0 else None)
        t_iter = time.perf_counter()
        args = (dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], cones,
                dev["x0"], dev["s0"], dev["mu0"])
        kw = dict(kkt_block=kkt_block, rho_row_scale=dev["rho_row_scale"],
                  on_iter=on_iter, deadline=deadline, kkt_precond=kkt_precond,
                  scale_graph=dev["scale_graph"])
        out = carry = setup = None
        if (settings.adaptive_rho and settings.adaptive_rho_interval == 0
                and settings.max_iter > 2 * settings.check_termination):
            # the auto rho-adaptation interval from a timed probe
            dyn, carry, setup, out = self._resolve_auto_rho_interval(
                args, kw, dyn, static, settings, times)
        if out is None:
            out = solver_mod.solve(*args, dyn, static, carry_in=carry,
                                   setup_in=setup, **kw)
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
            loose_iter=out["loose_iter"],
            syncs=out["syncs"], refine_syncs=out["refine_syncs"],
            kkt_solver_iters=out["kkt_solver_iters"], kkt_reads=out["kkt_reads"],
            auto_rho_interval=self.auto_rho_interval,
            mesh_ranks=1 if shard is None else shard.size,
            collectives=None if shard is None else shard.calls - calls0,
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
            kkt_solver_iters=int(out["kkt_solver_iters"]),
            res_history=_order_history(out),
        )
        if settings.verbose_timing:
            self._measure_phase_times(times, dev, dyn, static, out, kkt_precond)
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
        if settings.verbose:
            printing.print_result(self, result)
        return result

    def _resolve_auto_rho_interval(self, args, kw, dyn, static, settings, times):
        """The auto rho-adaptation interval (reference: solver.jl:242-256,
        parameters.jl:75-92; ``cosmo_tpu.models.model``): two probe chunks
        of ``max(check_termination, 10)`` iterations through the carry, the
        second timed by the host clock after a sync; the interval lets about
        ``adaptive_rho_fraction`` of the set-up time pass between
        adaptations, as a multiple of ``check_termination``. The probe's
        iterations count toward the solve. Returns (dyn, carry, setup, the
        finished solve's output or None)."""
        probe = max(int(settings.check_termination), 10)

        def run(limit, carry=None, setup=None):
            out = solver_mod.solve(
                *args, dyn._replace(max_iter=torch.full_like(dyn.max_iter, limit)),
                static, carry_in=carry, return_carry=True, setup_in=setup, **kw)
            return out, out.pop("carry"), out.pop("setup")

        out, carry, setup = run(probe)
        if out["status"] != results_mod.MAX_ITER_REACHED:
            return dyn, carry, setup, out   # solved (or certified) in the probe
        _sync(self.device)
        t0 = time.perf_counter()
        out, carry, setup = run(2 * probe, carry, setup)   # ends in host reads
        per_iter = (time.perf_counter() - t0) / probe
        setup_s = times.graph_time + times.setup_time
        ct = max(int(settings.check_termination), 1)
        iv = settings.adaptive_rho_fraction * setup_s / max(per_iter, 1e-9)
        iv = min(max(int(round(iv / ct)) * ct, ct), int(settings.max_iter))
        shard = args[4].shard
        if shard is not None:
            # the ranks' clocks differ: rank 0's interval holds
            iv = int(shard.broadcast(torch.tensor([iv], device=self.device))[0])
        self.auto_rho_interval = iv
        dyn = dyn._replace(adaptive_rho_interval=torch.full_like(
            dyn.adaptive_rho_interval, iv))
        if out["status"] != results_mod.MAX_ITER_REACHED:
            return dyn, carry, setup, out
        return dyn, carry, setup, None

    def _measure_phase_times(self, times, dev, dyn, static, out, kkt_precond):
        """The per-phase timers under ``verbose_timing`` (reference:
        types.jl:26-58; ``cosmo_tpu.models.model._measure_phase_times``):
        each phase runs standalone on the solve's data, timed by the host
        clock between device syncs (best of 3 after a warm-up call), times
        how often the solve ran it."""
        from .. import accel
        from ..ops import projections

        def timed(fn, reps=3):
            fn()
            best = float("inf")
            for _ in range(reps):
                _sync(self.device)
                t0 = time.perf_counter()
                fn()
                _sync(self.device)
                best = min(best, time.perf_counter() - t0)
            return best

        Pd, Ad, qd, bd, cones = dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], dev["cones"]
        kkt_block = dev["kkt_block"]
        m, n = static.m, static.n
        n_iter = max(out["iter"] + out["safeguarding_iter"], 1)
        n_rho, n_acc = out["n_rho_adapt"], out["n_accelerated"]
        sigma, steps = dyn.sigma, static.kkt_refine_steps
        rho_vec = dyn.rho.expand(m).clone()
        r1 = torch.ones_like(qd)
        # the amortized backend projects from a fresh basis (the full sweeps)
        eig0 = projections.init_eig_state(cones, qd.dtype, self.device)
        with solver_mod._full_f32_matmuls():
            times.proj_time = timed(lambda: projections.project(bd, cones, eig0)) * n_iter
            times.scaling_time = (timed(lambda: scaling_ops.ruiz_scale(
                Pd, Ad, qd, bd, cones, static.scaling_iters, dyn))
                if static.scaling_iters > 0 else 0.0)
            if static.kkt_solver in (KKT_CG, KKT_MINRES):
                times.init_factor_time = times.factor_update_time = 0.0
                x0, tol = torch.zeros_like(qd), torch.full_like(sigma, 1e-6)
                if static.kkt_solver == KKT_MINRES:
                    def solve():
                        return kkt_ops.minres_solve(Pd, Ad, sigma, rho_vec, r1, bd, x0,
                                                    tol, tol, static.kkt_cg_max_iter,
                                                    steps)
                else:
                    # as the solve runs it: CUDA graph replays on the card
                    # (eager under a mesh)
                    graph = (kkt_ops.CGGraph()
                             if self.device.type == "cuda" and cones.shard is None
                             else None)

                    def solve():
                        return kkt_ops.cg_solve(Pd, Ad, sigma, rho_vec, r1, bd, x0, tol,
                                                tol, static.kkt_cg_max_iter, steps,
                                                precond=kkt_precond, graph=graph)
            else:
                if not isinstance(static.kkt_solver, str):
                    # a custom KKT plug-in: its own setup and solve
                    plug = static.kkt_solver

                    def factor():
                        return plug.setup(Pd, Ad, sigma, rho_vec)

                    def solve():
                        return plug.solve(st, Pd, Ad, sigma, rho_vec, r1, bd)
                elif static.kkt_solver == KKT_BLOCK:
                    def factor():
                        return blockkkt.factor(kkt_block, Pd, Ad, sigma, rho_vec,
                                               build_pair=steps > 0)

                    def solve():
                        return blockkkt.solve(kkt_block, st, Pd, Ad, sigma, rho_vec,
                                              r1, bd, steps)
                else:
                    def factor():
                        return kkt_ops.dense_factor(Pd, Ad, sigma, rho_vec,
                                                    static.accel_mem == 0)

                    def solve():
                        return kkt_ops.dense_solve(st, Pd, Ad, sigma, rho_vec, r1, bd,
                                                   steps)
                t_factor = timed(factor)
                times.init_factor_time = t_factor
                times.factor_update_time = t_factor * n_rho
                st = factor()
            # the x- and nu-update is the KKT solve
            times.update_time = timed(solve) * n_iter
            if static.accel_mem > 0 and n_acc > 0:
                aa = accel.init_accel(n + m, static.accel_mem, qd.dtype, self.device)
                w = torch.ones(n + m, dtype=qd.dtype, device=self.device)
                times.accelerate_time = timed(lambda: accel.accelerate(
                    aa, w, static.accel_type, static.accel_regularizer)) * n_acc
            else:
                times.accelerate_time = 0.0


def refine_hint(sets, chordal_info=None) -> bool:
    """Whether the auto ``kkt_refine_steps`` is 1 in float32 (the df32
    endgame): rho_eq-amplified rows (ZeroSet, Box with l == u) or a compact
    decomposition's overlap columns."""
    return any(
        isinstance(s, C.ZeroSet) or (isinstance(s, C.Box) and np.any(s.l == s.u))
        for s in sets
    ) or (chordal_info is not None and chordal_info.num_overlaps > 0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cone_sets_from_dict(cone: dict, l=None, u=None) -> List[C.ConvexSet]:
    """SCS-style cone dict -> ordered cone list (reference:
    interface.jl:319-366). Keys: "f" (zero rows), "l" (nonnegative rows),
    "q" (SOC dims), "s" (PSD triangle dims), "ep"/"ed" (numbers of
    exponential / dual exponential cones), "p" (power exponents, negative
    for the dual cone), "b" (a box with bounds l, u)."""
    sets: List[C.ConvexSet] = []
    if cone.get("f"):
        sets.append(C.ZeroSet(int(cone["f"])))
    if cone.get("l"):
        sets.append(C.Nonnegatives(int(cone["l"])))
    for dim in cone.get("q", []):
        sets.append(C.SecondOrderCone(int(dim)))
    for dim in cone.get("s", []):
        sets.append(C.PsdConeTriangle(int(dim)))
    for _ in range(int(cone.get("ep", 0))):
        sets.append(C.ExponentialCone())
    for _ in range(int(cone.get("ed", 0))):
        sets.append(C.DualExponentialCone())
    for expo in cone.get("p", []):
        if expo >= 0:
            sets.append(C.PowerCone(float(expo)))
        else:
            sets.append(C.DualPowerCone(-float(expo)))
    if cone.get("b"):
        sets.append(C.Box(l, u))
    return sets


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
