"""The ADMM core (the port of ``cosmo_tpu.solver``: ``solve`` with the
dense, the block-diagonal or the matrix-free CG/MINRES KKT, its resumable
carry, and ``solve_chunked``).

Reference call stack: src/solver.jl:78-203 (optimize!), :7-65 (admm_z!/
admm_x!/admm_w!), :242-292 (rho adaptation), :303-356 (termination),
src/accelerator_interface.jl (safeguarded Anderson acceleration).

The JAX package runs the whole solve as one jitted ``lax.while_loop`` with
``lax.cond`` gates. Here the loop is a host Python loop over device
tensors with the same check cadence, control lattice and statuses. Counters
and flags whose next value the host can compute (iteration, due flags,
certificate window, the refine latch between checks) stay Python values;
everything else stays on the device, where the accelerator's gates and the
safeguard's decline are value selections. The host waits for the device
only where the reference's control flow needs a device value:

* once per termination check (status, the refine latch, the forced rho
  update) and once per rho adaptation (whether rho changed);
* once per infeasibility check (status and the certificate window);
* under Anderson acceleration, while a rho update is pending: whether this
  iteration accelerated (deferred updates run on plain iterations only);
  that flag is copied to pinned host memory right after the accelerator
  step and read after the projection is queued;
* under the safeguard, once per iteration: whether the previous pass was
  declined (then this pass is its plain replay, which counts as a
  safeguarding iteration). That flag is copied to pinned host memory right
  after the safeguard, and read after the next pass's accelerator step and
  projection are queued.

So the card works on the queued projection while the host waits for a
flag. With CG or MINRES the KKT solve adds one host read of its loop
condition per block of steps (``ops/kkt.py``).

With the block-diagonal KKT (``ops/blockkkt.py``) the x half of the
operator variable lives in the block-space layout for the whole loop (the
block-space x carry of ``cosmo_tpu.solver``): n-space x is materialized
only at the checks and at exit.

With ``mixed_precision`` the polar projection's float32 products run as
three TF32 passes (``ops/eigh.matmul_3xtf32``) until the relative
residuals first fall to ``mixed_precision_switch`` at a termination check
(a one-way latch, read with that check's flags), then in full float32
(``cosmo_tpu.solver``: the loose phase). A custom KKT solver
(``Settings.kkt_solver = CustomKKTSolver(setup, solve)``) takes the place of
the built-in factor and solve.

A solve can stop and resume: ``return_carry=True`` returns the loop state
(:class:`LoopCarry`, the device tensors with the host counters and flags)
and the set-up outputs (:class:`SetupState`); ``carry_in``/``setup_in``
continue from them, skipping the scaling, so a solve run in chunks of
``max_iter`` (:func:`solve_chunked`) follows the trajectory of one
uninterrupted solve.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from . import accel, results
from .ops import blockkkt
from .ops import df32
from .ops import infeasibility as infeas
from .ops import kkt as kkt_ops
from .ops import projections
from .ops import residuals as res_ops
from .ops import scaling as scaling_ops
from .ops.linops import Coo
from .settings import DynConfig, StaticConfig, KKT_BLOCK, KKT_CG, KKT_DENSE, KKT_MINRES
from .utils import printing

RHO_LOG_LEN = 64

# Base number of plain ADMM steps of an infeasibility-certificate window on
# the shadow trajectory; stagnant checks with loose-certificate evidence
# escalate it x4 up to 512 (cosmo_tpu.solver, INFEAS_PLAIN_WINDOW)
INFEAS_PLAIN_WINDOW = 1

# the control lattice (cosmo_tpu.solver, where each was tuned):
# refined-endgame latch: the stall fallback fires after this many checks
# without a 5% residual-score improvement, but only within
# REFINE_NEAR_SWITCH x of the switch; REFINE_STALL_LAST_RESORT is the
# far-from-switch escape for extreme-kappa floors
REFINE_STALL_CHECKS = 4
REFINE_NEAR_SWITCH = 50.0
REFINE_STALL_LAST_RESORT = 16
# Anderson stall toggle: a trip with score > AA_STRIKE_FACTOR x best is a
# strike (divergence evidence); AA_STRIKE_KILL strikes disable the
# accelerator for the rest of the solve; a suspended accelerator re-arms
# only while the score is within AA_REARM_FACTOR x of the best
AA_STRIKE_FACTOR = 100.0
AA_STRIKE_KILL = 2
AA_REARM_FACTOR = 10.0
# forced deadband-free rho re-adaptations per solve, fired on a stall trip
# while the residuals are far from termination
FORCED_RHO_BUDGET = 2
# consecutive stagnant+evidence checks before the certificate window escalates
ESCALATE_STAG_CHECKS = 2

# rho row classes (reference: src/parameters.jl:17-49)
_RHO_NORMAL = 0
_RHO_EQ = 1
_RHO_LOOSE = 2


def _make_rho_vec(rho, rho_class, dyn, row_scale=None):
    """rho per row from the row class (reference: parameters.jl:17-49),
    optionally times a static per-row scale (the decomposition-overlap
    weighting, Settings.rho_overlap_scale)."""
    rv = torch.where(
        rho_class == _RHO_EQ,
        rho * dyn.rho_eq_over_rho_ineq,
        torch.where(rho_class == _RHO_LOOSE, dyn.rho_min, rho),
    )
    if row_scale is not None:
        rv = torch.clamp(rv * row_scale, dyn.rho_min, dyn.rho_max)
    return rv


def _classify_rows(cones, b, lb, ub, dyn):
    """Constraint classification on scaled data (reference: setup.jl:75-85,
    convexset.jl:62-69 and :831-842)."""
    thresh = dyn.infty * dyn.min_scaling
    cls = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    cls = torch.where(cones.eq_mask, _RHO_EQ, cls)
    cls = torch.where(cones.nonneg_mask & (b > thresh), _RHO_LOOSE, cls)
    box_loose = cones.box_mask & (lb < -thresh) & (ub > thresh)
    box_eq = cones.box_mask & ((ub - lb) < dyn.rho_tol)
    return torch.where(box_loose, _RHO_LOOSE, torch.where(box_eq, _RHO_EQ, cls))


def check_supported(static: StaticConfig):
    """Raise ValueError for a KKT solver name this solver does not know (a
    :class:`~cosmo_tpu_torch.settings.CustomKKTSolver` is taken as is)."""
    if isinstance(static.kkt_solver, str) and static.kkt_solver not in (
            KKT_DENSE, KKT_BLOCK, KKT_CG, KKT_MINRES):
        raise ValueError(f"unknown kkt_solver {static.kkt_solver!r}")


@contextlib.contextmanager
def _full_f32_matmuls():
    """float32 products in full float32 (no TF32) — the counterpart of the
    JAX package's ``matmul_precision="highest"``: the Anderson Gram, the
    block inverses' applies and the einsums over the block-dense A. Only
    the polar projection of the mixed-precision loose phase opts back into
    TF32, as three passes (``ops/eigh.matmul_3xtf32``): a single
    reduced-precision pass floors the residuals above the switches."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class _FlagReader:
    """Brings one device bool to the host. On a CUDA device :meth:`post`
    queues its copy into pinned memory and records an event, and
    :meth:`read` waits on that event only, not on the work queued after it.
    Each read that waits counts in ``waits``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.buf = torch.empty(1, dtype=torch.bool, pin_memory=True)
            self.event = torch.cuda.Event()
        self.flag = None
        self.value = False
        self.waits = 0

    def post(self, flag):
        if self.cuda:
            self.buf.copy_(flag.reshape(1), non_blocking=True)
            self.event.record()
        self.flag = flag

    def read(self) -> bool:
        if self.flag is not None:
            if self.cuda:
                self.event.synchronize()
                self.value = bool(self.buf[0])
            else:
                self.value = bool(self.flag)
            self.flag = None
            self.waits += 1
        return self.value


class SetupState(NamedTuple):
    """The set-up outputs on the device: the scaled problem data and the row
    classes. A resumed solve takes them back and skips the Ruiz scaling."""

    P: Any
    A: Any
    q: Any
    b: Any
    lb: Any
    ub: Any
    sm: Any              # ScaleMats
    rho_class: Any


@dataclasses.dataclass
class LoopCarry:
    """Loop state: device tensors, plus the host-side counters and flags. A
    solve with ``return_carry=True`` returns it; ``carry_in`` resumes from
    it (and consumes it: the resumed loop updates it in place)."""

    w: Any
    w_prev: Any
    s: Any
    rho: Any
    rho_vec: Any
    kkt: Any
    cost: Any
    res: Any
    dx: Any              # certificate base x, block space (first shadow step)
    dy: Any              # certificate base mu (set by the first shadow step)
    gx: Any              # main-trajectory x at the previous infeasibility check
    gy: Any              # main-trajectory mu at the previous infeasibility check
    w_sh: Any            # certificate shadow iterate (plain ADMM)
    mu_sh: Any           # shadow mu of the last shadow step
    chk_best: Any        # best residual score seen at a certificate check
    rho_log: Any
    hist: Any
    aa: Any = None       # AccelState, or None without acceleration
    redo: Any = None     # device bool: the safeguard declined this pass
    due_age: Any = None  # device int32: iterations a deferred rho update starved
    ref_stall: Any = None  # device int32: stagnant checks while refinement is off
    ref_best: Any = None   # best residual score seen while refinement is off
    sol: Any = None      # [n+m] last KKT solution, the CG/MINRES warm start
    eig: Any = ()        # the amortized backend's eigenbases, one a PSD bucket
    kkt_iters: Any = None  # device int32: inner CG/MINRES steps
    redo_reader: Any = None   # _FlagReader of ``redo``
    plain_reader: Any = None  # _FlagReader: this pass did not accelerate
    it: int = 0
    sg_iter: int = 0     # safeguarding (redo) passes
    status: int = results.UNDETERMINED
    infeas_due: bool = False
    rho_due: bool = False
    rho_force: bool = False  # a stall trip asked for a deadband-free rho update
    n_forced: int = 0
    dy_age: int = -1     # shadow steps since the window was armed (-1: not armed)
    inf_win: int = INFEAS_PLAIN_WINDOW
    stag_chks: int = 0
    refine_on: bool = True   # the df32 KKT refinement is latched on
    refine_iter: int = -1    # the iteration at which the latch tripped
    loose: bool = False      # the mixed-precision loose phase is still on
    loose_iter: int = -1     # the iteration at which the loose phase ended
    refine_syncs: int = 0    # host waits before the latch tripped
    n_rho_adapt: int = 0
    hist_n: int = 0
    projections: int = 0
    syncs: int = 0       # host waits for the device, the flag and CG reads aside
    kkt_reads: int = 0   # host reads of the CG/MINRES loop condition


def solve(P, A, q, b, cones, x0, s0, mu0, dyn: DynConfig, static: StaticConfig,
          kkt_block=None, rho_row_scale=None,
          on_iter: Optional[Callable[[int, bool], None]] = None,
          deadline: Optional[float] = None, kkt_precond=None, carry_in=None,
          return_carry: bool = False, setup_in=None, scale_graph=None):
    """Full solve of ``min 1/2 x'Px + q'x s.t. Ax + s = b, s in K`` on the
    device of ``q``, with float32 products in full float32. ``cones`` is a
    device ConeData. With the dense KKT, ``P`` is a dense tensor and ``A``
    dense or :class:`~cosmo_tpu_torch.ops.linops.Bde`; with ``kkt_solver ==
    "blockdiag"`` both are :class:`~cosmo_tpu_torch.ops.linops.Coo` and
    ``kkt_block`` is the device :class:`~cosmo_tpu_torch.ops.blockkkt.
    BlockKKTMeta`; with ``"cg"`` or ``"minres"`` both are dense or both
    ``Coo``, and CG takes the optional ``kkt_precond``
    (:class:`~cosmo_tpu_torch.ops.kkt.OverlapPrecond`). ``rho_row_scale``:
    an optional static per-row rho scale. ``on_iter(iteration, refine_on)``,
    if given, is called on the host after every pass (a profiling hook).
    ``deadline``: a ``time.perf_counter()`` value; a termination check that
    finds the solve undecided past it ends ``Time_limit_reached`` with the
    iterate of that check (the reference's wall-clock check,
    solver.jl:303-321). ``carry_in``/``setup_in``: the ``"carry"`` and
    ``"setup"`` of an earlier ``return_carry=True`` solve of the same
    problem; the loop resumes from them (``x0``, ``s0`` and ``mu0`` are then
    ignored) and runs until ``dyn.max_iter`` counts all its iterations.
    ``scale_graph``: a :class:`~cosmo_tpu_torch.ops.scaling.RuizGraph` that
    runs the scaling (a caller that solves one problem again keeps one).
    Returns a dict of host values (numpy arrays and Python numbers), plus
    ``"carry"`` and ``"setup"`` with ``return_carry``."""
    check_supported(static)
    with _full_f32_matmuls():
        return _solve(P, A, q, b, cones, x0, s0, mu0, dyn, static, kkt_block,
                      rho_row_scale, on_iter, deadline, kkt_precond, carry_in,
                      return_carry, setup_in, scale_graph)


def _solve(P, A, q, b, cones, x0, s0, mu0, dyn, static, kkt_block, rho_row_scale,
           on_iter, deadline, kkt_precond, carry_in, return_carry, setup_in,
           scale_graph):
    m, n = static.m, static.n
    dtype, device = q.dtype, q.device
    accel_on = static.accel_mem > 0
    guarded = accel_on and static.safeguard

    # ------------------------------------------------------------------
    # Setup (reference: solver.jl:96-138, setup.jl)
    # ------------------------------------------------------------------
    if setup_in is not None:
        P, A, q, b, lb, ub, sm, rho_class = setup_in
    elif static.scaling_iters > 0:
        P, A, q, b, lb, ub, sm = scaling_ops.ruiz_scale(
            P, A, q, b, cones, static.scaling_iters, dyn, graph=scale_graph
        )
    else:
        sm = scaling_ops.identity_scale(m, n, dtype, device)
        lb, ub = cones.lb, cones.ub
    cones = dataclasses.replace(cones, lb=lb, ub=ub)
    if setup_in is None:
        rho_class = _classify_rows(cones, b, lb, ub, dyn)
    setup = SetupState(P, A, q, b, lb, ub, sm, rho_class)

    # the periodic residual measurements ride the compensated matvecs once
    # the refine latch is on (before it, plain-f32 measurements are as
    # meaningful as the plain-f32 solves they measure)
    compensated_res = static.kkt_refine_steps > 0
    # endgame gate: KKT solves run plain while the relative residuals sit
    # above kkt_refine_switch; the refinement latches on, one way, at the
    # first termination check under the switch (or on the stall fallbacks)
    refine_gated = static.kkt_refine_gated and static.kkt_refine_steps > 0

    # a user plug-in (reference: AbstractKKTSolver, kktsolver.jl:5-11)
    custom_kkt = not isinstance(static.kkt_solver, str)
    use_block = static.kkt_solver == KKT_BLOCK
    use_cg = static.kkt_solver in (KKT_CG, KKT_MINRES)
    if use_block and kkt_block is None:
        raise ValueError("kkt_solver='blockdiag' needs the BlockKKTMeta "
                         "structure (pass kkt_block=blockkkt.analyze(P, A))")
    # Block-space x carry: with the fused block KKT the x half of w stays
    # in the concatenated component layout (a padded permutation of x whose
    # pad slots stay exactly 0), so the per-iteration column gather and x
    # scatter become slices; n-space x is built only at checks and at exit
    use_bspace = use_block and blockkkt.supports_blockspace(kkt_block)
    if use_bspace:
        cols_map = blockkkt.blockspace_cols(kkt_block)
        nx = blockkkt.blockspace_dim(kkt_block)

        def x_to_block(xv):
            return torch.cat([xv, xv.new_zeros(1)])[cols_map]

        def x_from_block(xg):
            out = xg.new_zeros(n + 1)
            out[cols_map] = xg
            return out[:n]
    else:
        nx = n

        def x_to_block(xv):
            return xv

        def x_from_block(xg):
            return xg
    qx = x_to_block(q)

    # compensated checks through the block-dense A (one batched pass per
    # bucket instead of the global df32 COO gathers)
    use_bspace_res = use_bspace and isinstance(P, Coo)
    if use_bspace_res:
        res_covered = blockkkt.covered_rows_mask(kkt_block, m)
        p_has_nnz = P.vals.numel() > 0

    def bspace_comp_res(c, x_k, s_k, mu_k, scaled: bool):
        """(rp, rd, mp, md) in double-f32 via the block-dense A."""
        if scaled:
            Einv_v, Dv, cinv_v = sm.Einv, sm.Dinv, sm.cinv
        else:
            Einv_v = torch.ones(m, dtype=dtype, device=device)
            Dv = torch.ones(n, dtype=dtype, device=device)
            cinv_v = torch.ones((), dtype=dtype, device=device)
        Px_pair_g = None
        if p_has_nnz:
            pxh, pxl = df32.matvec2(P, df32.promote(x_k))
            Px_pair_g = (x_to_block(pxh), x_to_block(pxl))
        return blockkkt.compensated_residuals(
            kkt_block, c.kkt, c.w_prev[:nx], s_k, mu_k, b, qx,
            Einv_v, x_to_block(Dv), cinv_v, Px_pair_g, covered=res_covered)

    def kkt_setup(rho_vec):
        if custom_kkt:
            return static.kkt_solver.setup(P, A, dyn.sigma, rho_vec)
        if use_cg:
            return None                       # matrix-free: no factor
        if use_block:
            return blockkkt.factor(kkt_block, P, A, dyn.sigma, rho_vec,
                                   build_pair=static.kkt_refine_steps > 0)
        # the explicit-inverse apply is plain-ADMM-only (kkt.dense_factor)
        return kkt_ops.dense_factor(P, A, dyn.sigma, rho_vec, not accel_on)

    # CG's blocks of steps as one CUDA graph replay each on the card
    cg_graph = (kkt_ops.CGGraph() if static.kkt_solver == KKT_CG and device.type == "cuda"
                else None)

    def kkt_solve(kkt, rho_vec, r1, r2, refine_on, sol_prev, admm_iter, res_min):
        """(x_tilde, nu, CG steps or None, host reads)"""
        if custom_kkt:
            xt, nu = static.kkt_solver.solve(kkt, P, A, dyn.sigma, rho_vec, r1, r2)
            return xt, nu, None, 0
        steps = static.kkt_refine_steps if (refine_on or not refine_gated) else 0
        if use_cg:
            sched = kkt_ops.cg_tolerance(admm_iter, dyn)
            if static.kkt_solver == KKT_MINRES:
                return kkt_ops.minres_solve(P, A, dyn.sigma, rho_vec, r1, r2,
                                            sol_prev[:n], sched, res_min,
                                            static.kkt_cg_max_iter, steps)
            return kkt_ops.cg_solve(P, A, dyn.sigma, rho_vec, r1, r2, sol_prev[:n],
                                    sched, res_min, static.kkt_cg_max_iter, steps,
                                    precond=kkt_precond, graph=cg_graph)
        if use_bspace:
            xt, nu = blockkkt.solve_blockspace(kkt_block, kkt, rho_vec, r1, r2, steps)
        elif use_block:
            xt, nu = blockkkt.solve(kkt_block, kkt, P, A, dyn.sigma, rho_vec, r1, r2,
                                    steps)
        else:
            xt, nu = kkt_ops.dense_solve(kkt, P, A, dyn.sigma, rho_vec, r1, r2, steps)
        return xt, nu, None, 0

    def admm_x_w(w, s, kkt, rho_vec, refine_on, sol_prev=None, admm_iter=1,
                 res_min=None):
        """admm_x! then admm_w! (solver.jl:32-65); the x half of w lives in
        block space when ``use_bspace`` (q rides along as ``qx``). Returns
        (w, the [n+m] KKT solution with CG or None, CG steps, host reads)."""
        r1 = dyn.sigma * w[:nx] - qx
        r2 = b - 2.0 * s + w[nx:]
        xt, nu, k, reads = kkt_solve(kkt, rho_vec, r1, r2, refine_on, sol_prev,
                                     admm_iter, res_min)
        s_tl = 2.0 * s - w[nx:] - nu / rho_vec
        w1 = w[:nx] + dyn.alpha * (xt - w[:nx])
        w2 = w[nx:] + dyn.alpha * (s_tl - s)
        return torch.cat([w1, w2]), (torch.cat([xt, nu]) if use_cg else None), k, reads

    def cg_res_min(c: LoopCarry):
        """the CG target's ADMM residual (None without CG)"""
        return torch.minimum(c.res.r_prim, c.res.r_dual) if use_cg else None

    def count_cg(c: LoopCarry, k, reads):
        if use_cg:
            c.kkt_iters, c.kkt_reads = c.kkt_iters + k, c.kkt_reads + reads

    def main_step(c: LoopCarry, admm_iter):
        """The ADMM step of this pass: w, and with CG its warm start and
        counters."""
        c.w, sol, k, reads = admm_x_w(c.w, c.s, c.kkt, c.rho_vec, c.refine_on,
                                      c.sol, admm_iter, cg_res_min(c))
        if use_cg:
            c.sol = sol
        count_cg(c, k, reads)

    def recover_mu(w_prev, s, rho_vec):
        """Moreau: mu = rho (w - Pi(w)) (solver.jl:23-26)."""
        return rho_vec * (w_prev[nx:] - s)

    def project(c: LoopCarry, v, eig):
        """(Pi_K(v), the eigenbasis carry after it) from the carry ``eig``."""
        c.projections += 1
        return projections.project(v, cones, eig, loose=c.loose)

    # the amortized backend's identity carry: the main trajectory's first
    # projection and every shadow projection start from it (the staleness
    # guard then runs the full sweeps); the shadow never reuses the main
    # iterate's basis (cosmo_tpu.solver)
    eig_fresh = projections.init_eig_state(cones, dtype, device)

    def host(c: LoopCarry, t):
        """A device tensor's values on the host: one wait."""
        c.syncs += 1
        return t.tolist()

    big = torch.full((), float("inf"), dtype=dtype, device=device)
    if carry_in is not None:
        # resume with the full solver state; only the status is reset so the
        # loop re-enters
        c = carry_in
        c.status = results.UNDETERMINED
    else:
        x, mu, s0v = scaling_ops.scale_variables(x0, mu0, s0, sm)
        rho = dyn.rho.clone()
        rho_vec = _make_rho_vec(rho, rho_class, dyn, rho_row_scale)
        rho_log = torch.zeros(RHO_LOG_LEN, dtype=dtype, device=device)
        rho_log[0] = rho
        kkt = kkt_setup(rho_vec)
        # initial half-step so iterates agree with standard ADMM
        # (solver.jl:125-138)
        refine_on0 = not refine_gated
        sol0 = torch.zeros(nx + m, dtype=dtype, device=device) if use_cg else None
        w0, sol0, k0, reads0 = admm_x_w(
            torch.cat([x_to_block(x), s0v + mu / rho_vec]), s0v, kkt, rho_vec,
            refine_on0, sol0, 1, big)
        zero = torch.zeros((), dtype=dtype, device=device)
        izero = torch.zeros((), dtype=torch.int32, device=device)
        c = LoopCarry(
            w=w0, w_prev=w0, s=s0v, rho=rho, rho_vec=rho_vec, kkt=kkt, cost=big,
            res=res_ops.ResInfo(big, big, zero, zero),
            dx=torch.zeros(nx, dtype=dtype, device=device),
            dy=torch.zeros(m, dtype=dtype, device=device),
            gx=torch.zeros(n, dtype=dtype, device=device),
            gy=torch.zeros(m, dtype=dtype, device=device),
            w_sh=w0, mu_sh=torch.zeros(m, dtype=dtype, device=device),
            chk_best=big, rho_log=rho_log,
            hist=(torch.zeros((static.res_hist, 6), dtype=dtype, device=device)
                  if static.res_hist > 0 else None),
            aa=(accel.init_accel(nx + m, static.accel_mem, dtype, device)
                if accel_on else None),
            redo=torch.zeros((), dtype=torch.bool, device=device),
            due_age=izero, ref_stall=izero, ref_best=big, refine_on=refine_on0,
            sol=sol0, kkt_iters=k0 if use_cg else izero, kkt_reads=reads0,
            redo_reader=_FlagReader(device), plain_reader=_FlagReader(device),
            loose=bool(static.mixed_precision), eig=eig_fresh,
        )
    redo_reader, plain_reader = c.redo_reader, c.plain_reader

    def waits(c: LoopCarry) -> int:
        return c.syncs + c.kkt_reads + redo_reader.waits + plain_reader.waits

    # ------------------------------------------------------------------
    # periodic work
    # ------------------------------------------------------------------
    def residuals_rt(c: LoopCarry, x_k, mu_k, scaled: bool):
        """(rp, rd, mp, md), compensated once the refine latch is on."""
        comp = compensated_res and c.refine_on
        if comp and use_bspace_res:
            return bspace_comp_res(c, x_k, c.s, mu_k, scaled)
        kw = dict(ignore_scaling=not scaled, compensated=comp)
        rp, rd = res_ops.calculate_residuals(P, A, q, b, x_k, c.s, mu_k, sm, **kw)
        mp, md = res_ops.max_res_component_norm(P, A, q, b, x_k, c.s, mu_k, sm, **kw)
        return rp, rd, mp, md

    def adapt_rho(c: LoopCarry):
        """reference: solver.jl:242-282, parameters.jl:53-92"""
        mu_k = recover_mu(c.w_prev, c.s, c.rho_vec)
        x_k = x_from_block(c.w_prev[:nx])
        rp, rd, mp, md = residuals_rt(c, x_k, mu_k, scaled=False)
        rp = rp / (mp + 1e-10)
        rd = rd / (md + 1e-10)
        new_rho = torch.clamp(c.rho * torch.sqrt(rp / (rd + 1e-10)),
                              dyn.rho_min, dyn.rho_max)
        # a forced update (a stall trip) bypasses the deadband: the update
        # re-expresses w and restarts the accelerator, an operator reset
        if not c.rho_force:
            changed = (new_rho > dyn.adaptive_rho_tolerance * c.rho) | (
                new_rho < c.rho / dyn.adaptive_rho_tolerance)
            if not host(c, changed):               # refactor?
                return
        c.rho_vec = _make_rho_vec(new_rho, rho_class, dyn, rho_row_scale)
        c.kkt = kkt_setup(c.rho_vec)
        # re-express w in the new scaling (solver.jl:278)
        c.w = torch.cat([c.w[:nx], mu_k / c.rho_vec + c.s])
        c.n_rho_adapt += 1
        c.rho_log[min(c.n_rho_adapt, RHO_LOG_LEN - 1)] = new_rho
        c.rho = new_rho
        if accel_on:
            c.aa = accel.restart(c.aa)

    def check_termination(c: LoopCarry):
        """reference: solver.jl:303-321, with the refine latch and the
        accelerator's activation and stall toggle (cosmo_tpu.solver)"""
        mu_k = recover_mu(c.w_prev, c.s, c.rho_vec)
        x_k = x_from_block(c.w_prev[:nx])
        info = res_ops.ResInfo(*residuals_rt(c, x_k, mu_k, scaled=True))
        cost = res_ops.calculate_cost(P, q, x_k, sm.cinv)
        conv_plain = res_ops.has_converged(info, dyn.eps_abs, dyn.eps_rel)
        # never SOLVED off an uncompensated measurement: a plain-converged
        # solve latches this check and the next one confirms compensated
        conv = conv_plain if (c.refine_on or not refine_gated) else torch.zeros_like(
            conv_plain)
        if static.check_obj_true:
            conv = conv & ((dyn.obj_true - cost).abs() <= dyn.obj_true_tol)
        c.cost, c.res = cost, info
        rel = torch.maximum(info.r_prim / (info.max_norm_prim + 1e-10),
                            info.r_dual / (info.max_norm_dual + 1e-10))
        trip = torch.zeros_like(conv)
        if refine_gated and not c.refine_on:
            # one-way latch; the stall fallback covers problems whose
            # plain-f32 floor sits above the switch, but only near it (a
            # transient plateau far above is ordinary ADMM dynamics), and
            # the last resort after 16 checks covers extreme-kappa floors
            stall = torch.where(rel < 0.95 * c.ref_best, torch.zeros_like(c.ref_stall),
                                c.ref_stall + 1)
            near_switch = rel < REFINE_NEAR_SWITCH * dyn.kkt_refine_switch
            trip = ((rel < dyn.kkt_refine_switch) | conv_plain
                    | ((stall >= REFINE_STALL_CHECKS) & near_switch)
                    | (stall >= REFINE_STALL_LAST_RESORT))
            c.ref_stall = stall
            c.ref_best = torch.minimum(c.ref_best, rel)
        if static.res_hist > 0:
            # residual-history ring: (iter, cost, r_prim, r_dual, rho, refine
            # latch as of the end of this check)
            row = torch.stack([
                torch.full((), float(c.it), dtype=dtype, device=device), cost,
                info.r_prim, info.r_dual, c.rho,
                (trip | c.refine_on).to(dtype),
            ])
            c.hist[c.hist_n % static.res_hist] = row
            c.hist_n += 1
        fire = torch.zeros_like(conv)
        if accel_on:
            fire = _accel_checks(c, info)
        flags = [cost.abs() > 1e20, conv, trip, fire]
        if c.loose:
            # the loose phase ends, one way, at the first check whose
            # relative residuals reach the switch
            flags.append(rel > dyn.mixed_precision_switch)
        row = [cost, info.r_prim, info.r_dual, c.rho] if static.verbose else []
        read = host(c, torch.stack([f.to(dtype) for f in flags] + row))
        unsolved, converged, tripped, fired = (bool(f) for f in read[:4])
        if static.verbose:
            printing.print_history_rows([[c.it, *read[len(flags):]]])
        if c.loose and not read[4]:
            c.loose, c.loose_iter = False, c.it
        if unsolved:
            c.status = results.UNSOLVED
        if c.status == results.UNDETERMINED and converged:
            c.status = results.SOLVED
        # the host has just read this check's flags, so the clock costs no
        # wait; the solve keeps the iterate the check measured
        if (c.status == results.UNDETERMINED and deadline is not None
                and time.perf_counter() > deadline):
            c.status = results.TIME_LIMIT_REACHED
        if tripped:
            c.refine_on, c.refine_iter = True, c.it
            c.refine_syncs = waits(c)
            # the accelerator's secant history spans the unrefined operator,
            # whose fixed point differs by the plain-f32 KKT forward error:
            # restart it at the switch
            if accel_on:
                c.aa = accel.restart(c.aa)
            # a marker for profiles that split plain from refined iterations
            with torch.profiler.record_function("cosmo_tpu_torch.refine_latch"):
                pass
        if fired:
            c.rho_force, c.n_forced = True, c.n_forced + 1

    def _accel_checks(c: LoopCarry, info):
        """The accelerator's accuracy activation and stall toggle at a
        termination check, on the device (cosmo_tpu.solver
        check_termination). Returns whether a forced rho update fires."""
        aa = c.aa
        if static.accel_activation == "accuracy":
            tol = dyn.accel_activation_accuracy
            near = (info.r_prim < tol + tol * info.max_norm_prim) & (
                info.r_dual < tol + tol * info.max_norm_dual)
            aa = dataclasses.replace(aa, active=(aa.active | near) & ~aa.disabled)
        fire = torch.zeros_like(aa.active)
        if static.accel_stall_checks > 0:
            # count checks with < 5% improvement of the normalized score; a
            # trip flips the suspension; a trip far above the best seen is
            # a strike, and two strikes kill the accelerator for good
            score = info.r_prim / (info.max_norm_prim + 1e-10) + info.r_dual / (
                info.max_norm_dual + 1e-10)
            improved = score < 0.95 * aa.best_score
            counting = aa.active | aa.disabled
            stall = torch.where(improved, torch.zeros_like(aa.stall_checks),
                                aa.stall_checks + counting.to(torch.int32))
            trip = stall >= static.accel_stall_checks
            strike = trip & ~aa.disabled & (score > AA_STRIKE_FACTOR * aa.best_score)
            n_trips = aa.n_trips + strike.to(torch.int32)
            dead = n_trips >= AA_STRIKE_KILL
            # never re-enable a suspended accelerator while the residuals
            # sit far above the best seen
            trip = trip & (~aa.disabled | (score <= AA_REARM_FACTOR * aa.best_score)) & ~dead
            aa = dataclasses.replace(
                aa,
                best_score=torch.minimum(aa.best_score, score),
                stall_checks=torch.where(trip, torch.zeros_like(stall), stall),
                disabled=(aa.disabled ^ trip) | dead,
                active=aa.active & ~trip & ~dead,
                n_trips=n_trips,
                count=torch.where(trip, torch.zeros_like(aa.count), aa.count),
                have_last=aa.have_last & ~trip,
            )
            if static.adaptive_rho and c.n_forced < FORCED_RHO_BUDGET:
                # only genuinely far from termination (near the tolerance
                # the forced reset's bump keeps the solve hovering)
                far = (info.r_prim > 10.0 * (dyn.eps_abs + dyn.eps_rel * info.max_norm_prim)) | (
                    info.r_dual > 10.0 * (dyn.eps_abs + dyn.eps_rel * info.max_norm_dual))
                fire = trip & far
        c.aa = aa
        return fire

    def shadow_step(c: LoopCarry):
        """One plain ADMM step of the certificate shadow trajectory; the
        first step after arming captures the delta base."""
        s_sh, _ = project(c, c.w_sh[nx:], eig_fresh)
        mu_sh = c.rho_vec * (c.w_sh[nx:] - s_sh)
        if c.dy_age == 0:
            c.dy, c.dx = mu_sh, c.w_sh[:nx]
        it_d = None
        if use_cg:
            # the CG schedule's iteration: this pass's, the previous one on
            # a redo pass
            it_d = (c.it + 1) - c.redo.to(torch.int32) if guarded else c.it + 1
        c.w_sh, _, k, reads = admm_x_w(c.w_sh, s_sh, c.kkt, c.rho_vec, c.refine_on,
                                       c.sol, it_d, cg_res_min(c))
        count_cg(c, k, reads)
        c.mu_sh = mu_sh
        c.dy_age += 1

    def check_infeasibility(c: LoopCarry):
        """Strict and 100x-loose certificates on the shadow deltas; the loose
        ones, with the main trajectory's check-to-check deltas, gate the
        window escalation (cosmo_tpu.solver.check_infeasibility)."""
        dy = c.dy - c.mu_sh
        dx = c.w_sh[:nx] - c.dx            # block space (carry layout)
        eps_p, eps_d = dyn.eps_prim_inf, dyn.eps_dual_inf
        prim_inf, prim_loose = infeas.is_primal_infeasible_multi(
            dy, A, b, cones, sm, (eps_p, 100.0 * eps_p))
        dual_inf, dual_loose = infeas.is_dual_infeasible_multi(
            x_from_block(dx), P, A, q, cones, sm, (eps_d, 100.0 * eps_d))
        mu_now = recover_mu(c.w_prev, c.s, c.rho_vec)
        x_now = x_from_block(c.w_prev[:nx])
        score = c.res.r_prim / (c.res.max_norm_prim + 1e-10) + c.res.r_dual / (
            c.res.max_norm_dual + 1e-10)
        stag_score = score >= 0.95 * c.chk_best
        prim_gate = infeas.is_primal_infeasible(
            c.gy - mu_now, A, b, cones, sm, 100.0 * eps_p)
        dual_gate = infeas.is_dual_infeasible(
            x_now - c.gx, P, A, q, cones, sm, 100.0 * eps_d)
        near = (prim_loose | (stag_score & prim_gate)
                | dual_loose | (stag_score & dual_gate))
        stagnant = stag_score & near
        c.cost = torch.where(prim_inf, big, c.cost)
        c.cost = torch.where(dual_inf & ~prim_inf, -big, c.cost)
        p_inf, d_inf, stag = host(c, torch.stack([prim_inf, dual_inf, stagnant]))
        if c.status == results.UNDETERMINED and p_inf:
            c.status = results.PRIMAL_INFEASIBLE
        if c.status == results.UNDETERMINED and d_inf:
            c.status = results.DUAL_INFEASIBLE
        c.stag_chks = c.stag_chks + 1 if stag else 0
        c.inf_win = (min(max(c.inf_win * 4, 8), 512)
                     if c.stag_chks >= ESCALATE_STAG_CHECKS else INFEAS_PLAIN_WINDOW)
        c.chk_best = torch.minimum(c.chk_best, score)
        c.dy, c.dx, c.gx, c.gy = dy, dx, x_now, mu_now
        c.infeas_due, c.dy_age = False, -1

    def safeguard(c: LoopCarry):
        """acceleration_post (accelerator_interface.jl:85-114) as value
        selections: a declined candidate rolls w back to the last genuine
        ADMM output and sets ``redo``, so the next pass replays the step as
        plain ADMM. Besides the per-step growth bound, the divergence anchor
        declines a candidate far above the best ||f|| seen."""
        aa = c.aa
        nrm_f = torch.linalg.vector_norm(aa.f_last)
        nrm_f_acc = torch.linalg.vector_norm(c.w_prev - c.w)
        best = torch.where(aa.success, torch.minimum(aa.best_nrm_f, nrm_f),
                           aa.best_nrm_f)
        bad = aa.success & ((nrm_f_acc > dyn.safeguard_tol * nrm_f)
                            | (nrm_f_acc > dyn.safeguard_anchor * best))
        c.w = torch.where(bad, aa.g_last, c.w)
        c.aa = dataclasses.replace(aa, best_nrm_f=best, success=aa.success & ~bad,
                                   n_declined=aa.n_declined + bad.to(torch.int32))
        c.redo = bad
        redo_reader.post(bad)

    def accelerate_pre(c: LoopCarry):
        """acceleration_pre (accelerator_interface.jl:58-75) on the device:
        the activation, then the history update and the candidate, gated
        off on a redo pass and, for the candidate, once a deferred rho
        update has starved a whole memory window."""
        aa = c.aa
        # this pass's iteration number: the previous one on a redo pass
        it_d = (c.it + 1) - c.redo.to(torch.int32)
        if static.accel_activation == "immediate":
            aa = dataclasses.replace(aa, active=(aa.active | (it_d >= 2)) & ~aa.disabled)
        elif static.accel_activation == "iter":
            aa = dataclasses.replace(
                aa, active=(aa.active | (it_d >= dyn.accel_activation_iter)) & ~aa.disabled)
        starved = c.due_age >= static.accel_mem
        gate_upd = aa.active & ~c.redo
        gate_acc = gate_upd & ~starved
        aa = accel.update(aa, c.w, c.w_prev, static.accel_memory, gate=gate_upd)
        c.w, c.aa = accel.accelerate(aa, c.w, static.accel_type,
                                     static.accel_regularizer, gate=gate_acc)

    # ------------------------------------------------------------------
    # main loop (solver.jl:140-165)
    # ------------------------------------------------------------------
    max_iter = int(dyn.max_iter)
    interval = int(dyn.adaptive_rho_interval)
    interval = interval if interval > 0 else 40
    while c.status == results.UNDETERMINED:
        # a declined step always gets its plain replay before the loop can
        # end, so the result is never a rejected candidate
        if c.it + c.sg_iter >= max_iter and not (guarded and redo_reader.read()):
            break
        if accel_on:
            accelerate_pre(c)
            deferred_ok = ~c.aa.success          # a plain iteration (device)
            if static.adaptive_rho:
                plain_reader.post(deferred_ok)
            pending = c.rho_due or c.rho_force
            c.due_age = torch.where(deferred_ok, torch.zeros_like(c.due_age),
                                    c.due_age + int(pending))

        # certificate shadow trajectory: forks from a plain-operator iterate
        # (the last genuine ADMM output when this pass accelerated)
        if static.infeas_enabled and c.infeas_due:
            if c.dy_age < 0:
                c.w_sh = (torch.where(c.aa.success, c.aa.g_last, c.w)
                          if accel_on else c.w)
                c.dy_age = 0
            shadow_step(c)

        c.w_prev = c.w
        # a declined step's redo pass keeps the basis the declined
        # projection produced, as the reference does
        c.s, c.eig = project(c, c.w[nx:], c.eig)

        # a redo pass repeats the declined step and counts as a
        # safeguarding iteration (accelerator_interface.jl:96-109)
        if guarded and redo_reader.read():
            c.sg_iter += 1
        else:
            c.it += 1
        it = c.it

        if static.adaptive_rho:
            c.rho_due = c.rho_due or (
                it % interval == 0
                and c.n_rho_adapt < static.adaptive_rho_max_adaptions)
            # a long armed certificate window holds the update pending;
            # deferred updates run on plain (non-accelerated) iterations only
            win_open = static.infeas_enabled and c.infeas_due and c.inf_win > 1
            if ((c.rho_due or c.rho_force) and not win_open
                    and (not accel_on or plain_reader.read())):
                adapt_rho(c)
                # the shadow's operator changed: its window restarts
                c.rho_due, c.rho_force, c.dy_age = False, False, -1

        main_step(c, it)
        if guarded:
            safeguard(c)

        # checks skip a pass whose candidate was just declined
        if ((it % static.check_termination == 0 or it == 1)
                and not (guarded and redo_reader.read())):
            check_termination(c)

        if static.infeas_enabled:
            do_check = c.infeas_due and c.dy_age >= c.inf_win + 1
            c.infeas_due = c.infeas_due or (
                it % static.check_infeasibility == 0
                and not (guarded and redo_reader.read()))
            if do_check:
                check_infeasibility(c)
        if on_iter is not None:
            on_iter(it, c.refine_on)

    # ------------------------------------------------------------------
    # post-processing (solver.jl:167-201)
    # ------------------------------------------------------------------
    # the carry keeps its own status and residuals, so a resumed solve
    # continues the uninterrupted trajectory
    mu_final = recover_mu(c.w_prev, c.s, c.rho_vec)
    x_final = x_from_block(c.w_prev[:nx])
    status, res = c.status, c.res
    if status == results.UNDETERMINED:
        res = res_ops.ResInfo(*residuals_rt(c, x_final, mu_final, scaled=True))
        status = results.MAX_ITER_REACHED
    # a diverged or non-factorizable solve surfaces as Unsolved
    finite = bool(torch.isfinite(x_final).all() & torch.isfinite(c.s).all())
    if not finite and status not in (results.PRIMAL_INFEASIBLE,
                                     results.DUAL_INFEASIBLE):
        status = results.UNSOLVED

    x_out, mu_out, s_out = scaling_ops.unscale_variables(x_final, mu_final, c.s, sm)
    n_acc = c.aa.n_accelerated if accel_on else torch.zeros((), device=device)
    scalars = torch.stack([c.cost, res.r_prim, res.r_dual, res.max_norm_prim,
                           res.max_norm_dual, n_acc.to(dtype),
                           c.kkt_iters.to(dtype)]).tolist()
    out = dict(
        x=x_out.cpu().numpy(),
        y=(-mu_out).cpu().numpy(),
        s=s_out.cpu().numpy(),
        cost=scalars[0],
        status=status,
        iter=c.it,
        safeguarding_iter=c.sg_iter,
        r_prim=scalars[1],
        r_dual=scalars[2],
        max_norm_prim=scalars[3],
        max_norm_dual=scalars[4],
        n_rho_adapt=c.n_rho_adapt,
        kkt_solver_iters=int(scalars[6]),
        rho_log=c.rho_log.cpu().numpy(),
        n_accelerated=int(scalars[5]),
        projections=c.projections,
        refine_iter=c.refine_iter,
        refine_syncs=c.refine_syncs,
        loose_iter=c.loose_iter,
        syncs=waits(c),
        kkt_reads=c.kkt_reads,
    )
    if static.res_hist > 0:
        out["res_hist"] = c.hist.cpu().numpy()
        out["res_hist_n"] = c.hist_n
    if return_carry:
        out["carry"], out["setup"] = c, setup
    return out


def solve_chunked(P, A, q, b, cones, x0, s0, mu0, dyn: DynConfig,
                  static: StaticConfig, chunk: int = 0, kkt_precond=None,
                  kkt_block=None, rho_row_scale=None):
    """:func:`solve` in chunks of at most ``chunk`` iterations: a host loop
    that raises ``max_iter`` by ``chunk`` and resumes through the carry
    until the solve ends or reaches ``dyn.max_iter``
    (``cosmo_tpu.solver.solve_chunked``). It follows the trajectory of one
    uninterrupted solve. ``chunk <= 0`` solves in one call."""
    max_iter = int(dyn.max_iter)
    kw = dict(kkt_precond=kkt_precond, kkt_block=kkt_block,
              rho_row_scale=rho_row_scale)
    if chunk <= 0 or max_iter <= chunk:
        return solve(P, A, q, b, cones, x0, s0, mu0, dyn, static, **kw)
    carry = setup = None
    limit = 0
    while True:
        limit = min(limit + chunk, max_iter)
        out = solve(P, A, q, b, cones, x0, s0, mu0,
                    dyn._replace(max_iter=torch.full_like(dyn.max_iter, limit)),
                    static, carry_in=carry, return_carry=True, setup_in=setup, **kw)
        carry, setup = out.pop("carry"), out.pop("setup")
        if out["status"] != results.MAX_ITER_REACHED or limit >= max_iter:
            return out
