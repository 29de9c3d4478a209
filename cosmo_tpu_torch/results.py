"""Result objects and status codes (reference: src/types.jl:26-156); a copy
of ``cosmo_tpu.results``."""
from __future__ import annotations

import dataclasses
import numpy as np

# status codes used on device (int32)
UNDETERMINED = 0
SOLVED = 1
MAX_ITER_REACHED = 2
PRIMAL_INFEASIBLE = 3
DUAL_INFEASIBLE = 4
UNSOLVED = 5
TIME_LIMIT_REACHED = 6

STATUS_NAMES = {
    UNDETERMINED: "Undetermined",
    SOLVED: "Solved",
    MAX_ITER_REACHED: "Max_iter_reached",
    PRIMAL_INFEASIBLE: "Primal_infeasible",
    DUAL_INFEASIBLE: "Dual_infeasible",
    UNSOLVED: "Unsolved",
    TIME_LIMIT_REACHED: "Time_limit_reached",
}


@dataclasses.dataclass
class ResultTimes:
    """Phase timers (reference: src/types.jl:26-58). Only host-observable
    phases are populated; `iter_time` includes the device execution of the
    whole loop."""

    solver_time: float = float("nan")
    setup_time: float = float("nan")
    scaling_time: float = float("nan")
    graph_time: float = float("nan")
    init_factor_time: float = float("nan")
    factor_update_time: float = float("nan")
    iter_time: float = float("nan")
    proj_time: float = float("nan")
    post_time: float = float("nan")
    update_time: float = float("nan")
    accelerate_time: float = float("nan")
    compile_time: float = float("nan")   # kept for parity with cosmo_tpu


@dataclasses.dataclass
class ResultInfo:
    """(reference: src/types.jl:65-71)"""

    r_prim: float
    r_dual: float
    max_norm_prim: float
    max_norm_dual: float
    rho_updates: np.ndarray
    # residuals within nearly_ratio x the tolerances (reference:
    # residuals.jl:119-125; used by MOI for NEARLY_ statuses)
    nearly_feasible: bool = False
    # total inner CG/MINRES iterations across the solve (0 for dense KKT)
    kkt_solver_iters: int = 0
    # device-side residual history: chronological [k, 5] rows of
    # (iter, cost, r_prim, r_dual, rho) captured at the termination checks
    # (Settings.residual_history ring; the reference analog is
    # IterateHistory, types.jl:283-312). None when disabled.
    res_history: np.ndarray = None


@dataclasses.dataclass
class Result:
    """Solver result (reference: src/types.jl:93-130)."""

    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    obj_val: float
    iter: int
    safeguarding_iter: int
    status: str
    info: ResultInfo
    times: ResultTimes

    def __repr__(self):
        return (
            f">>> COSMO-TPU - Results\nStatus: {self.status}\n"
            f"Iterations: {self.iter} (incl. {self.safeguarding_iter} safeguarding)\n"
            f"Optimal objective: {self.obj_val:.4g}\n"
            f"Runtime: {self.times.solver_time:.3f}s\n"
        )
