"""Exponential- and power-cone membership tests and the plain PyTorch
versions of their projections (the port of ``cosmo_tpu.ops.exp_pow``;
reference: src/convexset.jl:497-618 for K_exp, an SCS-derived bisection on
the dual variable with an inner Newton solve, and :626-742 for K_pow,
Newton on the Hien (2015) optimality condition).

The JAX package projects every cone of a family in one ``jax.vmap`` of
nested ``lax.while_loop``: each lane stops at its own condition and keeps
its carry after that. :func:`project_exp_plain` and
:func:`project_pow_plain` reproduce those per-lane semantics with batched
masked steps (``torch.where(active, new, old)``) and stop when no lane is
active, which costs one host read a step: they are the CPU route and the
yardstick of the hand-written kernel (:mod:`.exp_pow_proj`), never the
card's path.

Types follow the reference's weak-typed Python constants exactly:

* the bisection variables ``l``, ``u`` and ``lam`` start as Python floats
  and are carried in float64 (the JAX package's tests run with x64 on);
  each use beside a float32 value rounds them to float32, and ``lam**2``
  is squared in float64 before it is rounded;
* ``max(., 1e-300)`` is ``max(., 0)`` in float32 (1e-300 rounds to 0);
* ``_exp_safe``'s clip at 708 still overflows to inf in float32.

Dual cones use the Moreau identity Pi_{K*}(v) = v + Pi_K(-v)
(convexset.jl:784-789).

``stats``, where given, counts the work a lane-per-thread kernel does on
these rows: ``"rows"``, ``"evals"`` (evaluations of g(lambda) or of the
pow Newton's end point, by lanes still in their loop) and ``"newton"``
(inner Newton steps of those lanes). ``chip_smoke.py`` bounds the kernel's
time by them. With ``per_row``, :func:`project_exp_plain` and
:func:`project_pow_plain` also keep each row's counts, ``"row_evals"`` and
``"row_newton"`` (int64 [N], 0 in cases 1-3), beside the totals: the work
of each lane of a one-thread-a-cone layout, from which ``chip_smoke.py``
reckons lane efficiencies.
"""
from __future__ import annotations

import math

import torch

# the inner Newton's and the bound search's step limits (exp_pow.py:49, :91)
EXP_NEWTON_STEPS = 150
EXP_BOUND_STEPS = 90


def _tiny(dtype) -> float:
    """1e-300 rounded to ``dtype`` (0 in float32)."""
    return 1e-300 if dtype == torch.float64 else 0.0


def _exp_safe(t):
    """exp with its argument clipped to [-708, 708] (inf stays possible in
    float32)."""
    return torch.exp(torch.clamp(t, -708.0, 708.0))


# ----------------------------------------------------------------------
# Exponential cone
# ----------------------------------------------------------------------

def exp_in_cone(v, tol):
    """(x, y, z) in K_exp (convexset.jl:602-607); ``tol`` a float or a
    tensor broadcast over the rows of ``v`` [..., 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    ys = torch.where(y > 0, y, torch.ones_like(y))
    interior = (y > 0) & (y * _exp_safe(x / ys) <= z + tol)
    boundary = (x <= tol) & (y == 0.0) & (z >= -tol)
    return interior | boundary


def exp_in_dual(v, tol):
    """(x, y, z) in K_exp^* (convexset.jl:609-614)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    xs = torch.where(x < 0, x, torch.full_like(x, -1.0))
    c1 = (x < 0) & (-x * _exp_safe(y / xs) - math.e * z <= tol)
    c2 = (x.abs() <= tol) & (y >= -tol) & (z >= -tol)
    return c1 | c2


def _count(stats, key, lanes, rows=None):
    """Add the ``lanes`` that do a step to ``stats[key]`` and, where the
    stats keep per-row counts, to ``stats["row_" + key]`` at ``rows`` (the
    lanes' rows of the stack)."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(lanes.sum())
        per_row = stats.get("row_" + key)
        if per_row is not None and rows is not None:
            per_row.index_add_(0, rows, lanes.long())


def _find_min_t(lam, s0, t0, tol, stats=None, lanes=None, rows=None):
    """The inner Newton for t* given lambda (convexset.jl:582-600), on every
    lane at once; ``lam`` is float64, rounded beside the lanes' values.
    ``lanes``: the lanes whose steps ``stats`` counts (``rows``: theirs)."""
    dtype = s0.dtype
    lam_c = lam.to(dtype)
    lam2 = (lam * lam).to(dtype)
    tiny = _tiny(dtype)
    neg_t0 = -t0
    s0_lam = s0 / lam_c                   # the same value every step
    zero = torch.zeros_like(t0)
    dt = torch.maximum(neg_t0, tol)
    done = torch.zeros_like(dt, dtype=torch.bool)
    for k in range(EXP_NEWTON_STEPS):
        # a step on lanes that are all done changes nothing, so the host
        # reads the stop condition every 4 steps only
        if k % 4 == 0 and bool(done.all()):
            break
        if stats is not None:
            _count(stats, "newton", ~done & lanes, rows)
        dts = torch.clamp(dt, min=tiny)
        f = dt * (dt + t0) / lam2 - s0_lam + torch.log(dts / lam_c) + 1.0
        gf = (2.0 * dt + t0) / lam2 + 1.0 / dts
        dtn = dt - f / gf
        hit_low = dtn <= neg_t0
        hit_zero = dtn <= 0.0
        dtn = torch.where(hit_low, neg_t0, torch.where(hit_zero, zero, dtn))
        dt = torch.where(done, dt, dtn)
        done = done | hit_low | hit_zero | (f.abs() < tol)
    return dt + t0


def _exp_grad_dual(lam, r0, s0, t0, tol, stats=None, lanes=None, rows=None):
    """g(lambda) and its minimizer (r, s, t) (convexset.jl:565-577)."""
    dtype = s0.dtype
    tiny = _tiny(dtype)
    if stats is not None:
        lanes = torch.ones_like(s0, dtype=torch.bool) if lanes is None else lanes
        _count(stats, "evals", lanes, rows)
    t = _find_min_t(lam, s0, t0, tol, stats, lanes, rows)
    lam_c = lam.to(dtype)
    s = (t - t0) * t / lam_c
    r = r0 - lam_c
    g = torch.where(s == 0.0, r,
               r + s * torch.log(torch.clamp(s, min=tiny) / torch.clamp(t, min=tiny)))
    return g, torch.stack([r, s, t], dim=-1)


def _project_exp_case4(v, tol, max_iter, stats=None, rows=None):
    """Bisection on the dual variable lambda (convexset.jl:539-563): the
    exponential search for the upper bound, one bisection step, then the
    bisection while u - l >= tol, each lane on its own (``rows``: the
    lanes' rows, for per-row counts)."""
    r0, s0, t0 = v[:, 0], v[:, 1], v[:, 2]
    n = v.shape[0]
    f64 = dict(dtype=torch.float64, device=v.device)
    lam = torch.full((n,), 0.125, **f64)
    low = torch.zeros(n, **f64)
    g, _ = _exp_grad_dual(lam, r0, s0, t0, tol, stats, rows=rows)
    for _ in range(EXP_BOUND_STEPS):
        active = g > 0
        if not bool(active.any()):
            break
        g_new, _ = _exp_grad_dual(lam * 2.0, r0, s0, t0, tol, stats, active, rows)
        low = torch.where(active, lam, low)
        lam = torch.where(active, lam * 2.0, lam)
        g = torch.where(active, g_new, g)
    up = lam

    def step(low, up, lanes=None):
        lam = (up + low) / 2.0
        g, sol = _exp_grad_dual(lam, r0, s0, t0, tol, stats, lanes, rows)
        pos = g > 0
        return torch.where(pos, lam, low), torch.where(pos, up, lam), sol

    # the reference loop evaluates at least once and breaks after updating
    low, up, sol = step(low, up)
    for _ in range(1, max_iter):
        # u - l is float64; the comparison rounds it to the lanes' type
        active = (up - low).to(v.dtype) >= tol
        if not bool(active.any()):
            break
        low_n, up_n, sol_n = step(low, up, active)
        low = torch.where(active, low_n, low)
        up = torch.where(active, up_n, up)
        sol = torch.where(active[:, None], sol_n, sol)
    return sol


def _project_exp_rows(U, tol, max_iter, stats=None):
    """Project each row of U [N, 3] onto K_exp (convexset.jl:510-534)."""
    case1 = exp_in_cone(U, 0.0)
    case2 = exp_in_dual(-U, 0.0)
    case3 = (U[:, 0] < 0) & (U[:, 1] < 0)
    out = torch.where(case1[:, None], U, torch.zeros_like(U))
    v3 = torch.stack([U[:, 0], 0.0 * U[:, 1], torch.clamp(U[:, 2], min=0.0)], dim=1)
    out = torch.where((~case1 & ~case2 & case3)[:, None], v3, out)
    # only the lanes in no other case run the bisection: the lanes are
    # independent, so this is the reference's value on every selected lane
    rest = ~(case1 | case2 | case3)
    if bool(rest.any()):
        idx = rest.nonzero().squeeze(1)
        out[idx] = _project_exp_case4(U[idx], tol[idx], max_iter, stats, idx)
    return out


def project_exp_plain(V, is_dual, tol=None, max_iter: int = 100, stats=None,
                      per_row: bool = False):
    """Project the rows of V [N, 3] onto K_exp, or onto K_exp^* where
    ``is_dual`` [N] (bool); ``tol`` [N] per-cone tolerances (default 1e-8).
    The plain version of the kernel (``exp_pow_proj.project_exp``).
    ``stats``: the work counts (module docstring), with ``per_row`` each
    row's too."""
    if V.shape[0] == 0:
        return V
    if tol is None:
        tol = torch.full((V.shape[0],), 1e-8, dtype=V.dtype, device=V.device)
    if stats is not None:
        stats["rows"] = stats.get("rows", 0) + V.shape[0]
        if per_row:
            for key in ("row_evals", "row_newton"):
                stats.setdefault(key, torch.zeros(V.shape[0], dtype=torch.int64,
                                                  device=V.device))
    U = torch.where(is_dual[:, None], -V, V)
    P = _project_exp_rows(U, tol, max_iter, stats)
    return torch.where(is_dual[:, None], V + P, P)


# ----------------------------------------------------------------------
# Power cone
# ----------------------------------------------------------------------

def pow_in_cone(v, alpha, tol):
    """(x, y, z) in K_pow(alpha) (convexset.jl:726-730)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    xp = torch.clamp(x, min=0.0)
    yp = torch.clamp(y, min=0.0)
    return (x >= 0) & (y >= 0) & (xp ** alpha * yp ** (1 - alpha) >= z.abs() - tol)


def pow_in_dual(v, alpha, tol):
    """K_pow^* membership (convexset.jl:732-738)."""
    s, t, w = v[..., 0], v[..., 1], v[..., 2]
    sp = torch.clamp(s, min=0.0)
    tp = torch.clamp(t, min=0.0)
    lhs = sp ** alpha * tp ** (1 - alpha)
    rhs = w.abs() * alpha ** alpha * (1 - alpha) ** (1 - alpha) - tol
    return (s >= -tol) & (t >= -tol) & (lhs >= rhs)


def _phic(x0, z0, r, a):
    return torch.clamp(0.5 * (x0 + torch.sqrt(x0 * x0 + 4.0 * a * r * (z0.abs() - r))),
                       min=1e-10)


def _project_pow_case4(v, alpha, tol, max_iter, stats=None, rows=None):
    """Newton on r (convexset.jl:676-704), each lane stopping on its own;
    then one more evaluation of (px, py) at the final r (``rows``: the
    lanes' rows, for per-row counts)."""
    x0, y0, z0 = v[:, 0], v[:, 1], v[:, 2]
    az0 = z0.abs()
    r = az0 / 2.0
    done = torch.zeros_like(r, dtype=torch.bool)
    for _ in range(max_iter):
        active = ~done
        if not bool(active.any()):
            break
        _count(stats, "newton", active, rows)
        px = _phic(x0, z0, r, alpha)
        py = _phic(y0, z0, r, 1.0 - alpha)
        phi = px ** alpha * py ** (1.0 - alpha) - r
        conv = phi.abs() < tol
        dpx = alpha / (2.0 * px - x0) * (az0 - 2.0 * r)
        dpy = (1.0 - alpha) / (2.0 * py - y0) * (az0 - 2.0 * r)
        dphi = px ** alpha * py ** (1.0 - alpha) * (
            alpha * dpx / px + (1.0 - alpha) * dpy / py) - 1.0
        r_new = torch.minimum(torch.maximum(r - phi / dphi, torch.zeros_like(r)), az0)
        r = torch.where(active & ~conv, r_new, r)
        done = done | conv
    _count(stats, "evals", torch.ones_like(done), rows)
    px = _phic(x0, z0, r, alpha)
    py = _phic(y0, z0, r, 1.0 - alpha)
    z_out = z0 * r / torch.clamp(az0, min=_tiny(v.dtype))
    return torch.stack([px, py, z_out], dim=1)


def _project_pow_rows(U, alpha, tol, max_iter, stats=None):
    case1 = pow_in_cone(U, alpha, 0.0)
    case2 = pow_in_dual(-U, alpha, 0.0)
    case3 = U[:, 2].abs() <= tol
    out = torch.where(case1[:, None], U, torch.zeros_like(U))
    v3 = torch.stack([torch.clamp(U[:, 0], min=0.0), torch.clamp(U[:, 1], min=0.0),
                      U[:, 2]], dim=1)
    out = torch.where((~case1 & ~case2 & case3)[:, None], v3, out)
    rest = ~(case1 | case2 | case3)
    if bool(rest.any()):
        idx = rest.nonzero().squeeze(1)
        out[idx] = _project_pow_case4(U[idx], alpha[idx], tol[idx], max_iter, stats, idx)
    return out


def project_pow_plain(V, alpha, is_dual, tol=None, max_iter: int = 20, stats=None,
                      per_row: bool = False):
    """Project the rows of V [N, 3] onto K_pow(alpha) [N], or onto its dual
    where ``is_dual``; ``tol`` [N] per-cone tolerances (default 1e-8). The
    plain version of the kernel (``exp_pow_proj.project_pow``).
    ``stats``: the work counts (module docstring), with ``per_row`` each
    row's too."""
    if V.shape[0] == 0:
        return V
    if tol is None:
        tol = torch.full((V.shape[0],), 1e-8, dtype=V.dtype, device=V.device)
    if stats is not None:
        stats["rows"] = stats.get("rows", 0) + V.shape[0]
        if per_row:
            for key in ("row_evals", "row_newton"):
                stats.setdefault(key, torch.zeros(V.shape[0], dtype=torch.int64,
                                                  device=V.device))
    U = torch.where(is_dual[:, None], -V, V)
    P = _project_pow_rows(U, alpha, tol, max_iter, stats)
    return torch.where(is_dual[:, None], V + P, P)
