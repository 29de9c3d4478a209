"""CVXPY adapter, the modeling-language entry point (the port of
``cosmo_tpu.cvxpy_solver``; reference: the MOI wrapper,
src/MOI_wrapper.jl:135 Optimizer, :206 copy_to, :234 optimize!, :520-595
status mapping with the NEARLY_* distinction):

    import cvxpy as cp
    from cosmo_tpu_torch.cvxpy_solver import CosmoTpuSolver

    prob.solve(solver=CosmoTpuSolver())        # cvxpy >= 1.3

The adapter subclasses CVXPY's SCS conic interface, so it takes the cone
program CVXPY canonicalizes for SCS (zero, nonnegative, SOC, PSD triangle,
exponential and power cones: the cone dict of ``Model.set_csc``) and
CVXPY's own apply/invert; only the solve is replaced. Solver options pass
through: settings fields by name, ``cosmo_settings`` (a whole
:class:`~cosmo_tpu_torch.settings.Settings`) and ``device`` (None: cuda).

Importing this module does not import cvxpy (an optional dependency):
:func:`_load_base` resolves it at first use.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _load_base():
    """CVXPY's SCS interface class; a clear error without cvxpy."""
    try:
        from cvxpy.reductions.solvers.conic_solvers.scs_conif import SCS
    except ImportError as e:
        raise ImportError(
            "cvxpy is required for the CVXPY adapter: pip install cvxpy") from e
    return SCS


# SCS 3.x status codes, the contract CVXPY's SCS.invert() reads
_SCS_SOLVED = 1
_SCS_SOLVED_INACCURATE = 2
_SCS_UNBOUNDED = -1            # Dual_infeasible
_SCS_INFEASIBLE = -2           # Primal_infeasible
_SCS_INDETERMINATE = 0

_STATUS_TO_SCS = {
    "Solved": _SCS_SOLVED,
    "Primal_infeasible": _SCS_INFEASIBLE,
    "Dual_infeasible": _SCS_UNBOUNDED,
    "Unsolved": _SCS_INDETERMINATE,
    "Undetermined": _SCS_INDETERMINATE,
}


def _cone_dict_from_dims(dims) -> Dict[str, Any]:
    """CVXPY ConeDims -> the SCS-style cone dict of ``Model.set_csc``."""
    cone: Dict[str, Any] = {}
    if dims.zero:
        cone["f"] = int(dims.zero)
    if dims.nonneg:
        cone["l"] = int(dims.nonneg)
    if getattr(dims, "soc", None):
        cone["q"] = [int(d) for d in dims.soc]
    if getattr(dims, "psd", None):
        # CVXPY's psd dims are matrix sides; the cone dict (as the
        # reference's convex_sets_from_dict, interface.jl:330-336) takes
        # svec triangle entry counts
        cone["s"] = [int(d) * (int(d) + 1) // 2 for d in dims.psd]
    ep = int(getattr(dims, "exp", 0) or 0)
    if ep:
        cone["ep"] = ep
    p3d = getattr(dims, "p3d", None)
    if p3d:
        cone["p"] = [float(a) for a in p3d]
    return cone


def solve_conic_data(data: Dict[str, Any], settings=None, warm_start=None,
                     mesh=None, device=None):
    """Solve CVXPY-canonicalized conic data (the ``data`` dict of
    ``apply()``: "A", "b", "c", "dims") on ``device`` (None: cuda) and
    return an SCS-3-style result dict. Usable without cvxpy for SCS-format
    problems. ``mesh``: a mesh of ``parallel.make_mesh``, passed to
    ``Model.optimize`` (every rank of it calls this with the same data)."""
    import scipy.sparse as sp

    from .models.model import Model, cone_sets_from_dict
    from .settings import Settings

    A = sp.csc_matrix(data["A"])
    b = np.asarray(data["b"], dtype=np.float64).ravel()
    c = np.asarray(data["c"], dtype=np.float64).ravel()
    n = A.shape[1]
    dims = data["dims"]
    cone = dims if isinstance(dims, dict) else _cone_dict_from_dims(dims)

    model = Model(settings if settings is not None else Settings(), device=device)
    model.set(sp.csc_matrix((n, n)), c, A, b, cone_sets_from_dict(cone))
    if warm_start is not None:
        x0, y0, s0 = warm_start
        if x0 is not None:
            model.warm_start_primal(x0)
        if y0 is not None:
            model.warm_start_dual(y0)
        if s0 is not None:
            model.warm_start_slack(s0)
    res = model.optimize(mesh=mesh)

    status_val = _STATUS_TO_SCS.get(res.status, _SCS_INDETERMINATE)
    if res.status in ("Max_iter_reached", "Time_limit_reached"):
        # the NEARLY_* distinction (MOI_wrapper.jl:560-575): within
        # nearly_ratio times the tolerances counts as inaccurately solved
        status_val = (_SCS_SOLVED_INACCURATE if res.info.nearly_feasible
                      else _SCS_INDETERMINATE)
    info = {
        "status": res.status,
        "status_val": status_val,
        "iter": int(res.iter),
        "pobj": float(res.obj_val),
        "dobj": float(res.obj_val),
        "res_pri": float(res.info.r_prim),
        "res_dual": float(res.info.r_dual),
        "solve_time": float(res.times.solver_time) * 1e3,   # ms, as SCS
        "setup_time": float(res.times.setup_time) * 1e3,
    }
    return {"x": res.x, "y": res.y, "s": res.s, "info": info}


class _CosmoTpuSolverFactory:
    """Builds the CVXPY ConicSolver subclass at first use, so importing
    this module never imports cvxpy."""

    _cls = None

    @classmethod
    def get(cls):
        if cls._cls is not None:
            return cls._cls
        SCS = _load_base()

        class CosmoTorch(SCS):
            """CVXPY conic solver backed by cosmo_tpu_torch (SCS's cone set)."""

            def name(self):
                return "COSMO_TPU_TORCH"

            def import_solver(self):
                import cosmo_tpu_torch  # noqa: F401

            def solve_via_data(self, data, warm_start, verbose, solver_opts,
                               solver_cache=None):
                from .settings import Settings

                opts = dict(solver_opts or {})
                mesh = opts.pop("mesh", None)
                device = opts.pop("device", None)
                settings = opts.pop("cosmo_settings", None)
                if settings is None:
                    known = {k: v for k, v in opts.items()
                             if k in Settings.__dataclass_fields__}
                    known.setdefault("verbose", bool(verbose))
                    settings = Settings(**known)
                ws = None
                if warm_start and solver_cache is not None and self.name() in solver_cache:
                    prev = solver_cache[self.name()]
                    ws = (prev.get("x"), prev.get("y"), prev.get("s"))
                solution = solve_conic_data(data, settings=settings, warm_start=ws,
                                            mesh=mesh, device=device)
                if solver_cache is not None:
                    solver_cache[self.name()] = solution
                return solution

        cls._cls = CosmoTorch
        return cls._cls


def CosmoTpuSolver():
    """The CVXPY solver object: ``prob.solve(solver=CosmoTpuSolver())``."""
    return _CosmoTpuSolverFactory.get()()
