"""Native modeling API: Model / assemble / set / warm starts / optimize (the
port of ``cosmo_tpu.models.model``; reference: src/interface.jl).

This layer prepares numpy data on the host — constraint merging, canonical
set ordering, the ``A <- -A`` sign flip that turns ``Ax + b in K`` into
``Ax + s = b, s in K`` — moves it to the model's torch device and unpacks
the solver's result. A ``Model`` runs on ``cuda`` unless it is given
``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp
import torch

from .. import results as results_mod
from .. import solver as solver_mod
from ..ops import conedata
from ..ops import linops
from ..ops.conedata import not_ported
from ..settings import KKT_DENSE, Settings, split_settings, torch_dtype
from . import cones as C
from .constraint import Constraint

# the block-diagonal KKT's structure limits (cosmo_tpu.ops.blockkkt)
_BLOCK_LADDER_MAX_PAIRS = 40_000_000
_BLOCK_MAX_MEM = 2 << 30
_BLOCK_LADDER = (1, 2, 4, 8, 16, 32, 64)


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


@contextlib.contextmanager
def _full_f32_matmuls():
    """float32 products in full float32 (no TF32) for the solve — the
    counterpart of the JAX package's ``matmul_precision="highest"``."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _canonical_coo(X):
    Xc = sp.coo_matrix(sp.csr_matrix(X))
    r = np.asarray(Xc.row, dtype=np.int64)
    c = np.asarray(Xc.col, dtype=np.int64)
    p = np.lexsort((c, r))
    return r[p], c[p]


def block_kkt_applies(P, A, max_block: int) -> bool:
    """Whether the JAX package's block-diagonal KKT (blockkkt.analyze) would
    take this sparse problem: the reduced system decouples into components
    of at most ``max_block`` columns within its memory limits. The port
    has no block KKT yet, so such a problem must raise rather than run the
    dense KKT in its place."""
    from scipy.sparse.csgraph import connected_components

    m, n = A.shape
    ar, ac = _canonical_coo(A)
    prow, pcol = _canonical_coo(P)
    counts = np.bincount(ar, minlength=m).astype(np.int64)
    if counts.size and counts.max() > max_block:
        return False
    if int((counts**2).sum()) + prow.size > _BLOCK_LADDER_MAX_PAIRS:
        return False
    same = ar[1:] == ar[:-1]
    eu = np.concatenate([ac[:-1][same], prow[prow != pcol]])
    ev = np.concatenate([ac[1:][same], pcol[prow != pcol]])
    graph = sp.csr_matrix((np.ones(eu.size, np.int8), (eu, ev)), shape=(n, n))
    n_comp, labels = connected_components(graph, directed=False)
    sizes = np.bincount(labels, minlength=n_comp).astype(np.int64)
    if sizes.max() > max_block:
        return False
    pad = np.empty(n_comp, np.int64)
    for k in _BLOCK_LADDER[::-1]:
        pad[sizes <= k] = k
    return int((pad**2).sum()) * 8 <= _BLOCK_MAX_MEM


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
        # what the last solve ran with, for introspection and tests
        self.last_solve: dict = {}

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
        return self

    # -- solve -----------------------------------------------------------
    def _check_supported(self, settings: Settings, mesh):
        if mesh is not None:
            raise not_ported("optimize(mesh=...)", "mesh")
        if settings.accelerator is not None:
            raise not_ported("Anderson acceleration (pass accelerator=None)",
                             "Anderson acceleration")
        if settings.decompose and any(
            isinstance(s, (C.PsdCone, C.PsdConeTriangle))
            and getattr(s, "decomposable", False) for s in self.sets
        ):
            raise not_ported("chordal decomposition (pass decompose=False)",
                             "chordal decomposition")
        if not isinstance(settings.kkt_solver, str) or settings.kkt_solver != KKT_DENSE:
            raise not_ported(f"kkt_solver={settings.kkt_solver!r}",
                             "Coo + CG" if settings.kkt_solver in ("cg", "minres")
                             else "block-diagonal KKT")
        if settings.time_limit and settings.time_limit > 0:
            raise not_ported("time_limit > 0", "time limit and chunking")
        if settings.adaptive_rho and settings.adaptive_rho_interval == 0:
            raise not_ported("adaptive_rho_interval == 0 (the auto probe)",
                             "time limit and chunking")

    def _device_operators(self, settings, dtype):
        """(P, A) on the device: dense tensors, or a dense P and a
        block-dense :class:`~cosmo_tpu_torch.ops.linops.Bde` A for sparse
        input whose rows come in uniform per-cone blocks."""
        P, A = self.P, self.A
        m, n = A.shape
        use_sparse = settings.sparse is True or (
            settings.sparse == "auto" and (sp.issparse(A) or sp.issparse(P)))
        if not use_sparse:
            return (torch.as_tensor(_to_dense(P), dtype=dtype, device=self.device),
                    torch.as_tensor(_to_dense(A), dtype=dtype, device=self.device))
        if block_kkt_applies(P, A, int(settings.kkt_block_max)):
            raise not_ported("a sparse problem whose reduced KKT system "
                             "decouples (the block-diagonal KKT)",
                             "block-diagonal KKT")
        bde = None
        dims = {s.dim for s in self.sets}
        if n <= 2048 and len(dims) == 1:
            bde = linops.bde_from_scipy(sp.csr_matrix(A), rb=dims.pop())
        if bde is None:
            raise not_ported("sparse input that does not take the block-dense "
                             "row layout (pass sparse=False to densify)",
                             "Coo + CG")
        return (torch.as_tensor(_to_dense(P), dtype=dtype, device=self.device),
                linops.bde_to_device(bde, self.device, dtype))

    def optimize(self, mesh=None) -> results_mod.Result:
        """Solve the assembled problem on the model's device."""
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
        times.graph_time = 0.0

        t_setup = time.perf_counter()
        dtype = _default_dtype(settings, self.device)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        m, n = self.A.shape
        cones = conedata.compile_cones(
            self.sets, dtype=np_dtype, psd_pad_to=settings.psd_pad_to,
            eigh_backend=settings.eigh_backend,
            jacobi_sweeps=settings.jacobi_sweeps,
            accel_on=settings.accelerator is not None,
            decomposed=False, device=self.device,
        )
        Pd, Ad = self._device_operators(settings, dtype)
        cones = conedata.to_device(cones, self.device, dtype)
        refine_hint = any(
            isinstance(s, C.ZeroSet)
            or (isinstance(s, C.Box) and np.any(s.l == s.u))
            for s in self.sets
        )
        static, dyn = split_settings(settings, m, n, dtype,
                                     refine_hint=refine_hint, device=self.device)

        def vec(v):
            return torch.as_tensor(v, dtype=dtype, device=self.device)

        times.setup_time = time.perf_counter() - t_setup
        t_iter = time.perf_counter()
        with _full_f32_matmuls():
            out = solver_mod.solve(Pd, Ad, vec(self.q), vec(self.b), cones,
                                   vec(np.zeros(n)), vec(np.zeros(m)), vec(np.zeros(m)),
                                   dyn, static)
        times.iter_time = time.perf_counter() - t_iter
        self.last_solve = dict(
            device=self.device, dtype=dtype, A_layout=type(Ad).__name__,
            eigh_backend=cones.eigh_backend,
            bucket_backends=tuple(b.backend or cones.eigh_backend
                                  for b in cones.psd_buckets),
            projections=out["projections"], iter_time=times.iter_time,
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
        times.post_time = 0.0
        times.solver_time = time.perf_counter() - t_solver
        result = results_mod.Result(
            x=out["x"], y=out["y"], s=out["s"],
            obj_val=float(out["cost"]),
            iter=int(out["iter"]),
            safeguarding_iter=0,
            status=status,
            info=info,
            times=times,
        )
        return result


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
