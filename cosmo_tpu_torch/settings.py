"""Solver settings.

The same option surface as ``cosmo_tpu.settings`` (field names, defaults and
``from_dict``), so a settings dict moves between the two packages unchanged.
At solve time the options split into a *static* part (ints, flags and
choices, read on the host) and a *dynamic* part (floats held as 0-d tensors
on the solve's device, in the solve's dtype).

Options that only steer the TPU program are accepted for keyword parity and
have no effect here: ``profile_dir``, ``dispatch_chunk`` (the loop is a
host loop; ``solver.solve_chunked(chunk=N)`` runs N-iteration chunks when
asked) and ``matmul_precision`` (float32 products always run in full
float32: the solve sets ``torch.backends.cuda.matmul.allow_tf32 = False``).
Every other option takes effect as in ``cosmo_tpu``, ``verbose_timing``,
``adaptive_rho_interval=0`` (the timed probe), ``mixed_precision`` (the
polar projection's products as three TF32 passes during the loose phase),
a custom KKT solver and every ``eigh_backend`` (the amortized one through
the kernels of ``ops/jacobi_eig.py`` on a CUDA device, ``jacobi_mm`` as
batched products) included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


# Accelerator activation kinds (reference: src/settings.jl:20-23)
ACTIVATION_IMMEDIATE = "immediate"
ACTIVATION_ITER = "iter"
ACTIVATION_ACCURACY = "accuracy"

# KKT solver kinds (reference: src/linear_solver/)
KKT_DENSE = "dense"
KKT_CG = "cg"
KKT_MINRES = "minres"
KKT_BLOCK = "blockdiag"

# Clique merge strategies (reference: src/chordal_decomposition/clique_merging.jl)
MERGE_CLIQUE_GRAPH = "clique_graph"
MERGE_PARENT_CHILD = "parent_child"
MERGE_NONE = "none"


@dataclasses.dataclass(eq=False)
class CustomKKTSolver:
    """User-supplied KKT solver plug-in (reference: the AbstractKKTSolver
    contract, src/linear_solver/kktsolver.jl:5-11): ``setup(P, A, sigma,
    rho_vec) -> state`` at every factorization and ``solve(state, P, A,
    sigma, rho_vec, r1, r2) -> (x, nu)`` at every iteration, torch
    callables on the solve's device (P and A as the solve holds them:
    dense tensors, or ``Coo`` for sparse input)."""

    setup: Any = None
    solve: Any = None

    def __post_init__(self):
        if self.setup is None or self.solve is None:
            raise ValueError("CustomKKTSolver needs both setup and solve functions")


@dataclasses.dataclass
class Settings:
    """User-facing solver settings; defaults follow the reference
    (src/settings.jl:101-139) and ``cosmo_tpu.Settings``."""

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-5
    eps_rel: float = 1e-5
    nearly_ratio: float = 100.0
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    max_iter: int = 5000
    verbose: bool = False
    kkt_solver: str = KKT_DENSE
    check_termination: int = 25
    check_infeasibility: int = 40
    scaling: int = 10
    MIN_SCALING: float = 1e-4
    MAX_SCALING: float = 1e4
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 40
    # 0.0 = auto: 1.5 with the block-diagonal KKT, else the reference's 5.0
    adaptive_rho_tolerance: float = 0.0
    adaptive_rho_fraction: float = 0.4
    adaptive_rho_max_adaptions: int = 2**31 - 1
    verbose_timing: bool = False
    RHO_MIN: float = 1e-6
    RHO_MAX: float = 1e6
    RHO_TOL: float = 1e-4
    RHO_EQ_OVER_RHO_INEQ: float = 1e3
    COSMO_INFTY: float = 1e20
    decompose: bool = True
    complete_dual: bool = False
    time_limit: float = 0.0
    obj_true: float = float("nan")
    obj_true_tol: float = 1e-3
    merge_strategy: str = MERGE_CLIQUE_GRAPH
    compact_transformation: bool = True
    accelerator: Optional[str] = "anderson"
    accelerator_mem: int = 15
    accelerator_memory: str = "restarted"
    accelerator_type: str = "type2"
    accelerator_regularizer: str = "none"
    accelerator_activation: str = ACTIVATION_IMMEDIATE
    accelerator_activation_iter: int = 2
    accelerator_activation_accuracy: float = 1e-4
    safeguard: bool = True
    safeguard_tol: float = 2.0
    safeguard_anchor: float = 100.0
    accelerator_stall_checks: int = -1
    kkt_cg_tol_constant: float = 0.1
    kkt_cg_tol_exponent: float = 1.5
    kkt_cg_max_iter: int = 250
    # -1 = auto: 1 in f32 when ZeroSet or l == u Box rows exist, else 0
    kkt_refine_steps: int = -1
    kkt_refine_switch: float = 1e-3
    rho_overlap_scale: float = 2.0
    kkt_overlap_precond: bool = True
    kkt_block_max: int = 64
    # "auto" keeps scipy-sparse inputs sparse; True forces sparse; False
    # densifies everything
    sparse: Any = "auto"
    psd_pad_to: int = 8
    colpad_min: int = 512
    # PSD projection backend. The names are the JAX package's:
    #   "pallas" -> the hand-written CUDA Jacobi kernel (ops/jacobi_proj.py;
    #               its plain PyTorch version for a tensor on the CPU),
    #   "xla"    -> torch.linalg.eigh,
    #   "jacobi" -> the batched round-parallel Jacobi of ops/eigh.py,
    #   "polar"  -> the Newton-Schulz polar projection of ops/eigh.py,
    #   "auto"   -> the kernel for a single bucket of side <= 16 without
    #               Anderson on a CUDA device, polar for the rest there,
    #               torch.linalg.eigh on the CPU (ops/conedata.py).
    eigh_backend: str = "auto"
    jacobi_sweeps: int = 8
    # None: float32 on a CUDA device, float64 on the CPU
    dtype: Any = None
    profile_dir: Any = None
    matmul_precision: str = "highest"
    mixed_precision: bool = False
    mixed_precision_switch: float = 1e-3
    # rows of the residual-history ring kept on the device (0 disables)
    residual_history: int = 64
    dispatch_chunk: int = 0

    def replace(self, **kwargs) -> "Settings":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        """Build settings from a plain string-keyed dict
        (reference: src/settings.jl:167-183)."""
        kwargs = {}
        for key, val in d.items():
            if key not in cls.__dataclass_fields__:
                raise KeyError(f"Unknown setting: {key}")
            kwargs[key] = val
        return cls(**kwargs)


class StaticConfig(NamedTuple):
    """Host-side solve configuration (ints, flags and choices)."""

    check_termination: int
    check_infeasibility: int
    scaling_iters: int
    adaptive_rho: bool
    adaptive_rho_max_adaptions: int
    infeas_enabled: bool
    kkt_solver: str
    kkt_cg_max_iter: int
    kkt_refine_steps: int
    kkt_refine_gated: bool
    accel_mem: int                 # 0 disables acceleration
    accel_activation: str
    accel_memory: str
    accel_type: str
    accel_regularizer: str
    accel_stall_checks: int        # 0 disables the stagnation detector
    safeguard: bool
    check_obj_true: bool
    verbose: bool
    mixed_precision: bool
    res_hist: int                  # residual-history ring rows (0 = off)
    m: int
    n: int


class DynConfig(NamedTuple):
    """Dynamic solve parameters as 0-d tensors on the solve's device: the
    iteration counts in int32, the rest in the problem's dtype."""

    max_iter: Any
    adaptive_rho_interval: Any
    rho: Any
    sigma: Any
    alpha: Any
    eps_abs: Any
    eps_rel: Any
    eps_prim_inf: Any
    eps_dual_inf: Any
    min_scaling: Any
    max_scaling: Any
    rho_min: Any
    rho_max: Any
    rho_tol: Any
    rho_eq_over_rho_ineq: Any
    infty: Any
    adaptive_rho_tolerance: Any
    safeguard_tol: Any
    safeguard_anchor: Any
    obj_true: Any
    obj_true_tol: Any
    accel_activation_iter: Any
    accel_activation_accuracy: Any
    kkt_cg_tol_constant: Any
    kkt_cg_tol_exponent: Any
    mixed_precision_switch: Any
    kkt_refine_switch: Any


def split_settings(settings: Settings, m: int, n: int, dtype,
                   refine_hint: bool = True,
                   device: torch.device | str | None = None
                   ) -> tuple[StaticConfig, DynConfig]:
    """Split user settings into (static, dynamic) solve configuration.

    ``dtype`` is a numpy or torch floating dtype. ``refine_hint``: whether
    the problem carries rho_eq-amplified rows (ZeroSet / Box with l == u),
    which make the auto ``kkt_refine_steps`` resolve to 1 in float32.
    ``device``: where the dynamic scalars live, the solve's device (None:
    ``cuda``, where the package's entry points solve by default).
    """
    device = torch.device("cuda" if device is None else device)
    tdtype = torch_dtype(dtype)
    is_f32 = tdtype == torch.float32
    accel_mem = settings.accelerator_mem if settings.accelerator == "anderson" else 0
    static = StaticConfig(
        check_termination=int(settings.check_termination),
        check_infeasibility=int(settings.check_infeasibility),
        scaling_iters=int(settings.scaling),
        adaptive_rho=bool(settings.adaptive_rho),
        adaptive_rho_max_adaptions=min(int(settings.adaptive_rho_max_adaptions), 2**31 - 1),
        infeas_enabled=(
            settings.eps_prim_inf > 0
            and settings.eps_dual_inf > 0
            and settings.check_infeasibility < settings.max_iter
        ),
        kkt_solver=settings.kkt_solver,
        kkt_cg_max_iter=int(settings.kkt_cg_max_iter),
        kkt_refine_steps=(
            int(settings.kkt_refine_steps) if settings.kkt_refine_steps >= 0
            else (1 if is_f32 and refine_hint else 0)
        ),
        kkt_refine_gated=bool(settings.kkt_refine_switch > 0),
        accel_mem=int(accel_mem),
        accel_activation=settings.accelerator_activation,
        accel_memory=settings.accelerator_memory,
        accel_type=settings.accelerator_type,
        accel_regularizer=settings.accelerator_regularizer,
        accel_stall_checks=(
            int(settings.accelerator_stall_checks)
            if settings.accelerator_stall_checks >= 0
            else (10 if is_f32 else 0)
        ),
        safeguard=bool(settings.safeguard),
        check_obj_true=not np.isnan(settings.obj_true),
        verbose=bool(settings.verbose),
        mixed_precision=bool(settings.mixed_precision),
        res_hist=int(settings.residual_history),
        m=int(m),
        n=int(n),
    )

    def f(x):
        return torch.tensor(x, dtype=tdtype, device=device)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    dyn = DynConfig(
        max_iter=i32(settings.max_iter),
        adaptive_rho_interval=i32(settings.adaptive_rho_interval),
        rho=f(settings.rho),
        sigma=f(settings.sigma),
        alpha=f(settings.alpha),
        eps_abs=f(settings.eps_abs),
        eps_rel=f(settings.eps_rel),
        eps_prim_inf=f(settings.eps_prim_inf),
        eps_dual_inf=f(settings.eps_dual_inf),
        min_scaling=f(settings.MIN_SCALING),
        max_scaling=f(settings.MAX_SCALING),
        rho_min=f(settings.RHO_MIN),
        rho_max=f(settings.RHO_MAX),
        rho_tol=f(settings.RHO_TOL),
        rho_eq_over_rho_ineq=f(settings.RHO_EQ_OVER_RHO_INEQ),
        infty=f(settings.COSMO_INFTY),
        adaptive_rho_tolerance=f(settings.adaptive_rho_tolerance
                                 if settings.adaptive_rho_tolerance > 0
                                 else 5.0),
        safeguard_tol=f(settings.safeguard_tol),
        safeguard_anchor=f(settings.safeguard_anchor),
        obj_true=f(settings.obj_true),
        obj_true_tol=f(settings.obj_true_tol),
        accel_activation_iter=i32(settings.accelerator_activation_iter),
        accel_activation_accuracy=f(settings.accelerator_activation_accuracy),
        kkt_cg_tol_constant=f(settings.kkt_cg_tol_constant),
        kkt_cg_tol_exponent=f(settings.kkt_cg_tol_exponent),
        mixed_precision_switch=f(settings.mixed_precision_switch),
        kkt_refine_switch=f(settings.kkt_refine_switch),
    )
    return static, dyn


def torch_dtype(dtype) -> torch.dtype:
    """The torch floating dtype for a numpy/torch dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]
