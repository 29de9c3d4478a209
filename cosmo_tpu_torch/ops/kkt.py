"""KKT solves of the ADMM x-update (the port of ``cosmo_tpu.ops.kkt``).

The reduced SPD system

    M x = r1 + A' (rho .* r2),     M = P + sigma I + A' diag(rho) A
    nu  = rho .* (A x - r2)

is solved either through a cached Cholesky factor of M (refactored when rho
changes): two triangular solves per iteration, or — in float32 without
Anderson acceleration — one matvec with the explicit inverse M^-1 formed
from the factor; or matrix-free by preconditioned CG (Jacobi, plus the
exact overlap-block inverse of a compact decomposition) or MINRES, with
the reference's decreasing tolerance schedule and, in float32, compensated
double-f32 restarts.

The JAX package runs CG and MINRES as a ``lax.while_loop`` that tests its
condition on the device every step. Here the steps run in blocks of
``CG_BLOCK``: each step evaluates the reference's condition on the device
as ``active`` and applies its update through ``torch.where(active, new,
old)``, so a step past convergence changes nothing, and the host reads the
condition once per block. The iterate and the step count are the
reference's; a solve costs one host read per block instead of one per
step. On a CUDA device the solver runs each block of CG steps as one
replay of a CUDA graph (:class:`CGGraph`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import df32
from .linops import AtRhoA, _segment_sum, diag_AtRhoA, diag_part, matvec, rmatvec

# CG / MINRES steps between two host reads of the loop condition
CG_BLOCK = 8


class DenseKKTState(NamedTuple):
    L: torch.Tensor   # [n, n] lower Cholesky factor of M
    Minv: Any         # [n, n] explicit M^-1 = L^-T L^-1 (f32 only), or None


def dense_factor(P, A, sigma, rho_vec, use_inverse: bool = False) -> DenseKKTState:
    n = P.shape[0]
    M = P + sigma * torch.eye(n, dtype=P.dtype, device=P.device) + AtRhoA(A, rho_vec)
    # a failed factorization gives a NaN factor, as JAX's cholesky does, so
    # the solve ends Unsolved instead of raising (and the host never waits)
    L, info = torch.linalg.cholesky_ex(M)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    if M.dtype != torch.float32 or not use_inverse:
        # backward-stable triangular solves: the default, and always the
        # choice in f64 (the reference-parity mode)
        return DenseKKTState(L=L, Minv=None)
    # f32 + plain ADMM: apply-by-inverse, one [n, n] matvec per iteration
    # instead of two dependent triangular solves. Only without Anderson:
    # the inverse's ~1e-5 apply-error floor destabilizes safeguarded AA
    # (cosmo_tpu.ops.kkt.dense_factor)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Minv = Linv.T @ Linv
    return DenseKKTState(L=L, Minv=0.5 * (Minv + Minv.T))


def _chol_solve(L, t):
    y = torch.linalg.solve_triangular(L, t[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def _kkt_apply(state: DenseKKTState, t):
    if state.Minv is None:
        return _chol_solve(state.L, t)
    return state.Minv @ t


def dense_solve(state: DenseKKTState, P, A, sigma, rho_vec, r1, r2,
                refine_steps: int = 0):
    """Solve the KKT system via the cached factor. Returns (x_tilde, nu).

    ``refine_steps`` > 0 runs that many iterative-refinement corrections
    with the residual computed in compensated double-f32 against the exact
    P, A, sigma and rho (ops/df32.py): the forward error drops from
    kappa(M) eps to the f32 representation floor."""
    if refine_steps <= 0:
        x = _kkt_apply(state, r1 + rmatvec(A, rho_vec * r2))
    else:
        t_pair = df32.kkt_rhs2(A, rho_vec, r1, r2)
        x_pair = df32.promote(_kkt_apply(state, t_pair[0]))
        for _ in range(refine_steps):
            r = df32.kkt_residual_pair(P, A, sigma, rho_vec, t_pair, x_pair)
            x_pair = df32.add(x_pair, df32.promote(_kkt_apply(state, r)))
        x = df32.to_f32(x_pair)
    nu = rho_vec * (matvec(A, x) - r2)
    return x, nu


# ----------------------------------------------------------------------
# Matrix-free CG and MINRES on the reduced system
# ----------------------------------------------------------------------

def _reduced_matvec(P, A, sigma, rho_vec, v):
    return matvec(P, v) + sigma * v + rmatvec(A, rho_vec * matvec(A, v))


@dataclasses.dataclass(frozen=True)
class OverlapPrecond:
    """Structure of the compact decomposition's overlap block (see
    ``cosmo_tpu.ops.kkt.OverlapPrecond``). Over the overlap columns the
    reduced KKT matrix is

        M22 = diag(sigma + rho_child) + sum_p rho_p 1_Gp 1_Gp'

    diagonal plus one rank-1 term for each parent row p over the group Gp
    of overlap variables that share it, so its inverse is block-diagonal in
    closed form (Sherman-Morrison). CG is preconditioned by Jacobi on the
    original columns and this exact inverse on the overlap columns."""

    n0: int                         # number of original (non-overlap) columns
    n_groups: int
    child_rows: Any = None          # int64 [K] decomposed row of each +1 entry
    group: Any = None               # int64 [K] densified parent-row group id
    group_parent_row: Any = None    # int64 [G] row of each group's parent


def make_overlap_precond(n0: int, child_rows, parent_rows, device=None) -> OverlapPrecond:
    """The preconditioner's structure from the transform's overlap row
    lists, as int64 tensors on ``device`` (None: cuda)."""
    device = torch.device("cuda" if device is None else device)
    uniq, inverse = np.unique(np.asarray(parent_rows), return_inverse=True)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return OverlapPrecond(n0=int(n0), n_groups=int(uniq.size),
                          child_rows=idx(child_rows), group=idx(inverse),
                          group_parent_row=idx(uniq))


def _cg_params(P, A, sigma, rho_vec, precond, target):
    """The tensors a CG step reads besides its state and the operators:
    sigma, rho, the target, the Jacobi diagonal inverse and, with the
    overlap preconditioner, its Sherman-Morrison terms."""
    prm = dict(sigma=sigma, rho=rho_vec, target=target,
               dinv=1.0 / (diag_part(P) + sigma + diag_AtRhoA(A, rho_vec)))
    if precond is not None:
        d2 = sigma + rho_vec[precond.child_rows]
        rho_p = rho_vec[precond.group_parent_row]
        sd = _segment_sum(1.0 / d2, precond.group, precond.n_groups)
        prm.update(d2=d2, rho_p=rho_p, denom=1.0 + rho_p * sd)
    return prm


def _cg_fns(P, A, precond, prm, max_iter: int):
    """(mv, prec, cond, body) of preconditioned CG over the tensors of
    ``prm`` (:func:`_cg_params`): the reduced matvec, the preconditioner
    application z = Minv_hat r, the reference's loop condition and one
    step of the state (k, x, r, p, rz)."""
    def mv(v):
        return _reduced_matvec(P, A, prm["sigma"], prm["rho"], v)

    def prec(r):
        if precond is None:
            return prm["dinv"] * r
        n0, d2 = precond.n0, prm["d2"]
        z1 = prm["dinv"][:n0] * r[:n0]
        w = r[n0:] / d2
        sw = _segment_sum(w, precond.group, precond.n_groups)
        coef = prm["rho_p"] * sw / prm["denom"]
        return torch.cat([z1, w - coef[precond.group] / d2])

    def cond(st):
        k, x, r, p, rz = st
        return (torch.linalg.vector_norm(r) > prm["target"]) & (k < max_iter)

    def body(st):
        k, x, r, p, rz = st
        Ap = mv(p)
        alpha = rz / torch.dot(p, Ap)
        x = torch.addcmul(x, alpha, p)                 # x + alpha p
        r = torch.addcmul(r, alpha, Ap, value=-1.0)    # r - alpha Ap
        z = prec(r)
        rz_new = torch.dot(r, z)
        p = torch.addcmul(z, rz_new / rz, p)           # z + beta p
        return k, x, r, p, rz_new

    return mv, prec, cond, body


def _cg_target(t, sched, res_min):
    """Absolute CG/MINRES residual target (``cosmo_tpu.ops.kkt._cg_target``):
    the schedule over ||t|| (kktsolver_indirect.jl:70), tightened to a tenth
    of the current ADMM residual and floored at 0.25 eps ||t||, just below
    the level where finite-precision CG stagnates."""
    eps_m = torch.finfo(t.dtype).eps
    tnorm = torch.linalg.vector_norm(t)
    tgt = torch.minimum(sched / torch.clamp(tnorm, min=1e-30), 0.1 * res_min)
    return torch.maximum(tgt, 0.25 * eps_m * tnorm)


def _masked_loop(state, cond, body, block: int):
    """Run ``state = body(state)`` while ``cond(state)`` holds, ``block``
    steps between host reads: each step applies its update where the
    condition holds on the device and counts it in ``state[0]``. Returns
    (state, host reads)."""
    reads = 0
    go = cond(state)
    while True:
        reads += 1
        if not bool(go):
            return state, reads
        for _ in range(block):
            new = body(state)
            state = (state[0] + go,) + tuple(
                torch.where(go, a, b) for a, b in zip(new[1:], state[1:]))
            go = cond(state)


class CGGraph:
    """The masked CG steps of :func:`cg_solve` as a CUDA graph: one replay
    runs a block of steps on static copies of the state and of the
    per-solve tensors, so a block costs one launch instead of ~33 a step
    (a CG step on a CUDA device is bound by the host's launches). The
    replayed steps are the eager ones: the same operations on the same
    values. It captures at the first sweep, and again when the operators,
    the preconditioner, the step budget, the block or the shapes change;
    a solver keeps one for the whole solve."""

    def __init__(self):
        self.key = None

    def _capture(self, key, st, prm, P, A, precond, max_iter, block):
        self.key, self.refs = key, (P, A, precond)    # keep the captured alive
        self.st = tuple(t.clone() for t in st)
        self.prm = {name: v.clone() for name, v in prm.items()}
        self.go = torch.zeros((), dtype=torch.bool, device=st[1].device)
        _, _, self.cond, body = _cg_fns(P, A, precond, self.prm, max_iter)

        def steps():
            for _ in range(block):
                new = body(self.st)
                for buf, v in zip(self.st[1:], new[1:]):
                    buf.copy_(torch.where(self.go, v, buf))
                self.st[0].add_(self.go)
                self.go.copy_(self.cond(self.st))

        # a warm-up outside the capture (library handles, workspaces); with
        # go false it changes no buffer
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            steps()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            steps()

    def run(self, st, prm, P, A, precond, max_iter: int, block: int):
        """:func:`_masked_loop` of the CG step from state ``st``: (state,
        host reads)."""
        key = (id(P), id(A), id(precond), max_iter, block, st[1].dtype,
               st[1].shape[0], tuple(sorted(prm)))
        if key != self.key:
            self._capture(key, st, prm, P, A, precond, max_iter, block)
        for buf, v in zip(self.st, st):
            buf.copy_(v)
        for name, v in prm.items():
            self.prm[name].copy_(v)
        self.go.copy_(self.cond(self.st))
        reads = 0
        while True:
            reads += 1
            if not bool(self.go):
                return tuple(t.clone() for t in self.st), reads
            self.graph.replay()


def cg_solve(P, A, sigma, rho_vec, r1, r2, x0, sched, res_min, max_iter: int,
             refine_steps: int = 0, precond: OverlapPrecond | None = None,
             block: int | None = None, graph: CGGraph | None = None):
    """Preconditioned CG on M x = r1 + A'(rho r2), warm-started at x0, to
    the target of :func:`_cg_target` or ``max_iter`` steps
    (``cosmo_tpu.ops.kkt.cg_solve``). ``refine_steps`` > 0 adds that many
    restarts from a compensated residual of the exact P, A, sigma and rho
    with the solution accumulated in double-f32; all sweeps share one
    ``max_iter`` budget. ``block``: steps between host reads (None:
    ``CG_BLOCK``). ``graph``: a :class:`CGGraph` that runs the blocks (CUDA
    tensors only), else they run eagerly. Returns (x_tilde, nu, k, reads):
    k the steps taken, a device int32; reads the host reads of the loop
    condition."""
    if refine_steps > 0:
        t_pair = df32.kkt_rhs2(A, rho_vec, r1, r2)
        t = df32.to_f32(t_pair)
    else:
        t = r1 + rmatvec(A, rho_vec * r2)
    prm = _cg_params(P, A, sigma, rho_vec, precond, _cg_target(t, sched, res_min))
    mv, prec, cond, body = _cg_fns(P, A, precond, prm, max_iter)
    block = block or CG_BLOCK

    def sweep(x, r, k):
        z = prec(r)
        st = (k, x, r, z, torch.dot(r, z))
        if graph is not None:
            st, reads = graph.run(st, prm, P, A, precond, max_iter, block)
        else:
            st, reads = _masked_loop(st, cond, body, block)
        return st[1], st[0], reads

    k = torch.zeros((), dtype=torch.int32, device=t.device)
    reads = 0
    if refine_steps > 0:
        x_pair = df32.promote(x0)
        zero = torch.zeros_like(x0)
        for _ in range(refine_steps + 1):
            r = df32.kkt_residual_pair(P, A, sigma, rho_vec, t_pair, x_pair)
            d, k, n_reads = sweep(zero, r, k)
            reads += n_reads
            x_pair = df32.add(x_pair, df32.promote(d))
        x = df32.to_f32(x_pair)
    else:
        x, k, reads = sweep(x0, t - mv(x0), k)
    nu = rho_vec * (matvec(A, x) - r2)
    return x, nu, k, reads


def minres_solve(P, A, sigma, rho_vec, r1, r2, x0, sched, res_min, max_iter: int,
                 refine_steps: int = 0, block: int | None = None):
    """Unpreconditioned MINRES (Lanczos + Givens) on the reduced system,
    warm-started at x0 (``cosmo_tpu.ops.kkt.minres_solve``; reference:
    kktsolver_indirect.jl:123-189), with the compensated restarts of
    :func:`cg_solve`. Returns (x_tilde, nu, k, reads) as :func:`cg_solve`."""
    if refine_steps > 0:
        t_pair = df32.kkt_rhs2(A, rho_vec, r1, r2)
        t = df32.to_f32(t_pair)
    else:
        t = r1 + rmatvec(A, rho_vec * r2)

    def mv(v):
        return _reduced_matvec(P, A, sigma, rho_vec, v)

    target = _cg_target(t, sched, res_min)

    def cond(st):
        return (st[-1] > target) & (st[0] < max_iter)

    def body(st):
        (k, x, vp, v, beta, eta, c_old, s_old, c, s, wp, w, resid) = st
        pvec = mv(v) - beta * vp
        alpha = torch.dot(v, pvec)
        pvec = pvec - alpha * v
        beta_new = torch.linalg.vector_norm(pvec)
        v_new = pvec / torch.clamp(beta_new, min=1e-30)

        # the previous rotations on the new column of T
        delta = c * alpha - c_old * s * beta
        gamma1 = s * alpha + c_old * c * beta
        epsilon = s_old * beta
        # a new rotation to zero beta_new
        gamma2 = torch.clamp(torch.sqrt(delta * delta + beta_new * beta_new), min=1e-30)
        c_new = delta / gamma2
        s_new = beta_new / gamma2

        w_new = (v - gamma1 * w - epsilon * wp) / gamma2
        x = x + c_new * eta * w_new
        eta_new = -s_new * eta
        return (k, x, v, v_new, beta_new, eta_new, c, s, c_new, s_new, w, w_new,
                eta_new.abs())

    def sweep(x, r0, k):
        beta1 = torch.linalg.vector_norm(r0)
        safe_beta1 = torch.clamp(beta1, min=1e-30)
        one, zero = torch.ones_like(beta1), torch.zeros_like(beta1)
        vz = torch.zeros_like(r0)
        st = (k, x, vz, r0 / safe_beta1, safe_beta1, safe_beta1,
              one, zero, one, zero, vz, vz, beta1)
        st, reads = _masked_loop(st, cond, body, block or CG_BLOCK)
        return st[1], st[0], reads

    k = torch.zeros((), dtype=torch.int32, device=t.device)
    reads = 0
    if refine_steps > 0:
        x_pair = df32.promote(x0)
        zero = torch.zeros_like(x0)
        for _ in range(refine_steps + 1):
            r0 = df32.kkt_residual_pair(P, A, sigma, rho_vec, t_pair, x_pair)
            d, k, n_reads = sweep(zero, r0, k)
            reads += n_reads
            x_pair = df32.add(x_pair, df32.promote(d))
        x = df32.to_f32(x_pair)
    else:
        x, k, reads = sweep(x0, t - mv(x0), k)
    nu = rho_vec * (matvec(A, x) - r2)
    return x, nu, k, reads


def cg_tolerance(admm_iter, dyn):
    """The reference's decreasing tolerance schedule c / iter^e
    (kktsolver_indirect.jl:168-170) as a device scalar; ``admm_iter`` is a
    Python int or a device integer tensor."""
    c = dyn.kkt_cg_tol_constant
    if isinstance(admm_iter, torch.Tensor):
        it = torch.clamp(admm_iter, min=1).to(c.dtype)
    else:
        it = torch.full((), float(max(int(admm_iter), 1)), dtype=c.dtype, device=c.device)
    return c / it ** dyn.kkt_cg_tol_exponent
