"""The ADMM core (the port of ``cosmo_tpu.solver.solve`` with the dense or
the block-diagonal KKT, without Anderson acceleration).

Reference call stack: src/solver.jl:78-203 (optimize!), :7-65 (admm_z!/
admm_x!/admm_w!), :242-292 (rho adaptation), :303-356 (termination).

The JAX package runs the whole solve as one jitted ``lax.while_loop`` with
``lax.cond`` gates. Here the loop is a host Python loop over device
tensors with the same check cadence, deferral rules and statuses. Counters
and flags whose next value the host can compute (iteration, due flags,
certificate window) stay Python ints; everything else stays on the device.
The host waits for the device only where a decision needs a device value:
once per termination check (status), once per rho adaptation (whether rho
changed, which decides the refactor) and once per infeasibility check
(status and the certificate window).

With the block-diagonal KKT (``ops/blockkkt.py``) the x half of the
operator variable lives in the block-space layout for the whole loop (the
block-space x carry of ``cosmo_tpu.solver``): n-space x is materialized
only at the checks and at exit.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import results
from .ops import blockkkt
from .ops import infeasibility as infeas
from .ops import kkt as kkt_ops
from .ops import projections
from .ops import residuals as res_ops
from .ops import scaling as scaling_ops
from .ops.conedata import not_ported
from .settings import DynConfig, StaticConfig, KKT_BLOCK, KKT_DENSE

RHO_LOG_LEN = 64

# Base number of plain ADMM steps of an infeasibility-certificate window on
# the shadow trajectory; stagnant checks with loose-certificate evidence
# escalate it x4 up to 512 (cosmo_tpu.solver, INFEAS_PLAIN_WINDOW)
INFEAS_PLAIN_WINDOW = 1
# consecutive stagnant+evidence checks before the window escalates
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
    """Raise NotImplementedError for a configuration this solver lacks."""
    if static.accel_mem > 0:
        raise not_ported("Anderson acceleration (Settings.accelerator)",
                         "Anderson acceleration")
    if not isinstance(static.kkt_solver, str) or static.kkt_solver not in (
            KKT_DENSE, KKT_BLOCK):
        raise not_ported(f"kkt_solver={static.kkt_solver!r}",
                         "Coo + CG" if static.kkt_solver in ("cg", "minres")
                         else "custom KKT solvers")
    if static.kkt_refine_steps > 0:
        raise not_ported("the compensated KKT refinement (kkt_refine_steps > 0; "
                         "auto in float32 with ZeroSet or l == u Box rows)",
                         "df32 endgame")
    if static.mixed_precision:
        raise not_ported("mixed_precision=True", "df32 endgame")


@dataclasses.dataclass
class _Loop:
    """Loop state: device tensors, plus the host-side counters and flags."""

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
    it: int = 0
    status: int = results.UNDETERMINED
    infeas_due: bool = False
    rho_due: bool = False
    dy_age: int = -1     # shadow steps since the window was armed (-1: not armed)
    inf_win: int = INFEAS_PLAIN_WINDOW
    stag_chks: int = 0
    n_rho_adapt: int = 0
    hist_n: int = 0
    projections: int = 0


def solve(P, A, q, b, cones, x0, s0, mu0, dyn: DynConfig, static: StaticConfig,
          kkt_block=None, rho_row_scale=None):
    """Full solve of ``min 1/2 x'Px + q'x s.t. Ax + s = b, s in K`` on the
    device of ``q``. ``cones`` is a device ConeData. With the dense KKT,
    ``P`` is a dense tensor and ``A`` dense or
    :class:`~cosmo_tpu_torch.ops.linops.Bde`; with ``kkt_solver ==
    "blockdiag"`` both are :class:`~cosmo_tpu_torch.ops.linops.Coo` and
    ``kkt_block`` is the device :class:`~cosmo_tpu_torch.ops.blockkkt.
    BlockKKTMeta`. ``rho_row_scale``: an optional static per-row rho scale.
    Returns a dict of host values (numpy arrays and Python numbers)."""
    check_supported(static)
    m, n = static.m, static.n
    dtype, device = q.dtype, q.device

    # ------------------------------------------------------------------
    # Setup (reference: solver.jl:96-138, setup.jl)
    # ------------------------------------------------------------------
    if static.scaling_iters > 0:
        P, A, q, b, lb, ub, sm = scaling_ops.ruiz_scale(
            P, A, q, b, cones, static.scaling_iters, dyn
        )
    else:
        sm = scaling_ops.identity_scale(m, n, dtype, device)
        lb, ub = cones.lb, cones.ub
    cones = dataclasses.replace(cones, lb=lb, ub=ub)
    x, mu, s0v = scaling_ops.scale_variables(x0, mu0, s0, sm)
    rho_class = _classify_rows(cones, b, lb, ub, dyn)
    rho = dyn.rho.clone()
    rho_vec = _make_rho_vec(rho, rho_class, dyn, rho_row_scale)
    rho_log = torch.zeros(RHO_LOG_LEN, dtype=dtype, device=device)
    rho_log[0] = rho

    use_block = static.kkt_solver == KKT_BLOCK
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

    # the explicit-inverse apply is plain-ADMM-only (kkt.dense_factor)
    use_inverse = static.accel_mem == 0

    def kkt_setup(rho_vec):
        if use_block:
            return blockkkt.factor(kkt_block, P, A, dyn.sigma, rho_vec)
        return kkt_ops.dense_factor(P, A, dyn.sigma, rho_vec, use_inverse)

    def kkt_solve(kkt, rho_vec, r1, r2):
        if use_bspace:
            return blockkkt.solve_blockspace(kkt_block, kkt, rho_vec, r1, r2)
        if use_block:
            return blockkkt.solve(kkt_block, kkt, A, rho_vec, r1, r2)
        return kkt_ops.dense_solve(kkt, A, rho_vec, r1, r2)

    kkt = kkt_setup(rho_vec)

    def admm_x_w(w, s, kkt, rho_vec):
        """admm_x! then admm_w! (solver.jl:32-65); the x half of w lives in
        block space when ``use_bspace`` (q rides along as ``qx``)."""
        r1 = dyn.sigma * w[:nx] - qx
        r2 = b - 2.0 * s + w[nx:]
        xt, nu = kkt_solve(kkt, rho_vec, r1, r2)
        s_tl = 2.0 * s - w[nx:] - nu / rho_vec
        w1 = w[:nx] + dyn.alpha * (xt - w[:nx])
        w2 = w[nx:] + dyn.alpha * (s_tl - s)
        return torch.cat([w1, w2])

    def recover_mu(w_prev, s, rho_vec):
        """Moreau: mu = rho (w - Pi(w)) (solver.jl:23-26)."""
        return rho_vec * (w_prev[nx:] - s)

    def project(c: _Loop, v):
        c.projections += 1
        return projections.project(v, cones)

    # initial half-step so iterates agree with standard ADMM (solver.jl:125-138)
    w0 = admm_x_w(torch.cat([x_to_block(x), s0v + mu / rho_vec]), s0v, kkt, rho_vec)
    big = torch.full((), float("inf"), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    c = _Loop(
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
    )

    # ------------------------------------------------------------------
    # periodic work
    # ------------------------------------------------------------------
    def adapt_rho(c: _Loop):
        """reference: solver.jl:242-282, parameters.jl:53-92"""
        mu_k = recover_mu(c.w_prev, c.s, c.rho_vec)
        x_k = x_from_block(c.w_prev[:nx])
        rp, rd = res_ops.calculate_residuals(P, A, q, b, x_k, c.s, mu_k, sm,
                                             ignore_scaling=True)
        mp, md = res_ops.max_res_component_norm(P, A, q, b, x_k, c.s, mu_k, sm,
                                                ignore_scaling=True)
        rp = rp / (mp + 1e-10)
        rd = rd / (md + 1e-10)
        new_rho = torch.clamp(c.rho * torch.sqrt(rp / (rd + 1e-10)),
                              dyn.rho_min, dyn.rho_max)
        changed = (new_rho > dyn.adaptive_rho_tolerance * c.rho) | (
            new_rho < c.rho / dyn.adaptive_rho_tolerance)
        if not bool(changed):                       # host sync: refactor?
            return
        c.rho_vec = _make_rho_vec(new_rho, rho_class, dyn, rho_row_scale)
        c.kkt = kkt_setup(c.rho_vec)
        # re-express w in the new scaling (solver.jl:278)
        c.w = torch.cat([c.w[:nx], mu_k / c.rho_vec + c.s])
        c.n_rho_adapt += 1
        c.rho_log[min(c.n_rho_adapt, RHO_LOG_LEN - 1)] = new_rho
        c.rho = new_rho

    def check_termination(c: _Loop):
        """reference: solver.jl:303-321"""
        mu_k = recover_mu(c.w_prev, c.s, c.rho_vec)
        x_k = x_from_block(c.w_prev[:nx])
        info = res_ops.result_info(P, A, q, b, x_k, c.s, mu_k, sm)
        cost = res_ops.calculate_cost(P, q, x_k, sm.cinv)
        conv = res_ops.has_converged(info, dyn.eps_abs, dyn.eps_rel)
        if static.check_obj_true:
            conv = conv & ((dyn.obj_true - cost).abs() <= dyn.obj_true_tol)
        c.cost, c.res = cost, info
        if static.res_hist > 0:
            # residual-history ring: (iter, cost, r_prim, r_dual, rho, refine
            # latch — always on without the f32 refinement)
            row = torch.stack([
                torch.tensor(float(c.it), dtype=dtype, device=device), cost,
                info.r_prim, info.r_dual, c.rho, torch.ones_like(cost),
            ])
            c.hist[c.hist_n % static.res_hist] = row
            c.hist_n += 1
        unsolved, converged = torch.stack([cost.abs() > 1e20, conv]).tolist()
        if static.verbose:
            print(f"{c.it}\t{cost.item():.4e}\t{info.r_prim.item():.4e}\t"
                  f"{info.r_dual.item():.4e}\t{c.rho.item():.4e}")
        if unsolved:
            c.status = results.UNSOLVED
        if c.status == results.UNDETERMINED and converged:
            c.status = results.SOLVED

    def shadow_step(c: _Loop):
        """One plain ADMM step of the certificate shadow trajectory; the
        first step after arming captures the delta base."""
        s_sh = project(c, c.w_sh[nx:])
        mu_sh = c.rho_vec * (c.w_sh[nx:] - s_sh)
        if c.dy_age == 0:
            c.dy, c.dx = mu_sh, c.w_sh[:nx]
        c.w_sh = admm_x_w(c.w_sh, s_sh, c.kkt, c.rho_vec)
        c.mu_sh = mu_sh
        c.dy_age += 1

    def check_infeasibility(c: _Loop):
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
        p_inf, d_inf, stag = torch.stack([prim_inf, dual_inf, stagnant]).tolist()
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

    # ------------------------------------------------------------------
    # main loop (solver.jl:140-165)
    # ------------------------------------------------------------------
    max_iter = int(dyn.max_iter)
    interval = int(dyn.adaptive_rho_interval)
    interval = interval if interval > 0 else 40
    while c.status == results.UNDETERMINED and c.it < max_iter:
        c.it += 1
        it = c.it
        if static.infeas_enabled and c.infeas_due:
            if c.dy_age < 0:        # arm: fork the shadow from the iterate
                c.w_sh, c.dy_age = c.w, 0
            shadow_step(c)

        c.w_prev = c.w
        c.s = project(c, c.w[nx:])

        if static.adaptive_rho:
            c.rho_due = c.rho_due or (
                it % interval == 0
                and c.n_rho_adapt < static.adaptive_rho_max_adaptions)
            # a long armed certificate window holds the update pending
            win_open = static.infeas_enabled and c.infeas_due and c.inf_win > 1
            if c.rho_due and not win_open:
                adapt_rho(c)
                # the shadow's operator changed: its window restarts
                c.rho_due, c.dy_age = False, -1

        c.w = admm_x_w(c.w, c.s, c.kkt, c.rho_vec)

        if it % static.check_termination == 0 or it == 1:
            check_termination(c)

        if static.infeas_enabled:
            do_check = c.infeas_due and c.dy_age >= c.inf_win + 1
            c.infeas_due = c.infeas_due or it % static.check_infeasibility == 0
            if do_check:
                check_infeasibility(c)

    # ------------------------------------------------------------------
    # post-processing (solver.jl:167-201)
    # ------------------------------------------------------------------
    mu_final = recover_mu(c.w_prev, c.s, c.rho_vec)
    x_final = x_from_block(c.w_prev[:nx])
    if c.status == results.UNDETERMINED:
        c.res = res_ops.result_info(P, A, q, b, x_final, c.s, mu_final, sm)
        c.status = results.MAX_ITER_REACHED
    # a diverged or non-factorizable solve surfaces as Unsolved
    finite = bool(torch.isfinite(x_final).all() & torch.isfinite(c.s).all())
    if not finite and c.status not in (results.PRIMAL_INFEASIBLE,
                                       results.DUAL_INFEASIBLE):
        c.status = results.UNSOLVED

    x_out, mu_out, s_out = scaling_ops.unscale_variables(x_final, mu_final, c.s, sm)
    scalars = torch.stack([c.cost, c.res.r_prim, c.res.r_dual,
                           c.res.max_norm_prim, c.res.max_norm_dual]).tolist()
    out = dict(
        x=x_out.cpu().numpy(),
        y=(-mu_out).cpu().numpy(),
        s=s_out.cpu().numpy(),
        cost=scalars[0],
        status=c.status,
        iter=c.it,
        safeguarding_iter=0,
        r_prim=scalars[1],
        r_dual=scalars[2],
        max_norm_prim=scalars[3],
        max_norm_dual=scalars[4],
        n_rho_adapt=c.n_rho_adapt,
        kkt_solver_iters=0,
        rho_log=c.rho_log.cpu().numpy(),
        n_accelerated=0,
        projections=c.projections,
    )
    if static.res_hist > 0:
        out["res_hist"] = c.hist.cpu().numpy()
        out["res_hist_n"] = c.hist_n
    return out
