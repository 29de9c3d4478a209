"""Problem suites and randomized problems through cosmo_tpu_torch against
cosmo_tpu, on the CPU in float64: ports of tests/test_problem_suites.py
(the maximum-singular-value chordal LMI, the SOCP lasso, the box QPs and
nuclear-norm matrix completion) and tests/test_fuzz.py (random LPs against
HiGHS, random QPs and an SOCP against their KKT conditions, infeasible and
unbounded LPs), the latter through the one-call ``solve``.

The port must pass the original test's checks and match the JAX package's
status, objective, x, y and s within 10 times the solve's eps (relative to
the larger of 1 and the largest entry).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu_torch.problems import smat

torch.set_num_threads(1)


def _model(mod, settings=None):
    s = settings if settings is not None else mod.Settings()
    return mod.Model(s, device="cpu") if mod is pt else mod.Model(s)


def _both(build):
    return build(ct), build(pt)


def _assert_same(rj, rt, tol):
    assert rj.status == rt.status
    if rj.status == "Solved":
        assert abs(rj.obj_val - rt.obj_val) <= tol * max(1.0, abs(rj.obj_val))
        for a in ("x", "y", "s"):
            ja, ta = getattr(rj, a), getattr(rt, a)
            assert np.abs(ja - ta).max() <= tol * max(1.0, np.abs(ja).max()), a


# ---- tests/test_problem_suites.py -----------------------------------------

def test_max_singular_value_chordal_lmi():
    """min t s.t. [tI Y; Y' tI] PSD and three linear constraints
    (nuclear_norm_minimization.jl), through the compact decomposition."""
    q = np.concatenate([[1.0], np.zeros(9)])
    A_lmi1 = np.array([-1.0, 0, -1, 0, 0, -1, 0, 0, 0, -1, 0, 0, 0, 0, -1,
                       0, 0, 0, 0, 0, -1])
    A_lmi2 = np.zeros((21, 9))
    for r, c in ((6, 0), (7, 1), (8, 2), (10, 3), (11, 4), (12, 5),
                 (15, 6), (16, 7), (17, 8)):
        A_lmi2[r, c] = -np.sqrt(2.0)
    A_lmi = np.concatenate([A_lmi1[:, None], A_lmi2], axis=1)

    def build(mod):
        cons = [
            mod.Constraint(np.concatenate([[0, 0, -1.0], np.zeros(7)]).reshape(1, -1),
                           np.array([4.0]), mod.Nonnegatives(1)),
            mod.Constraint(np.concatenate([[0, 0, 0, 0, 0, 1.0], np.zeros(4)]).reshape(1, -1),
                           np.array([-3.0]), mod.Nonnegatives(1)),
            mod.Constraint(np.concatenate([[0.0], np.ones(9)]).reshape(1, -1),
                           np.array([-12.0]), mod.Nonnegatives(1)),
            mod.Constraint(-A_lmi, np.zeros(21), mod.PsdConeTriangle(21)),
        ]
        model = _model(mod)
        model.assemble(np.zeros((10, 10)), q, cons, settings=mod.Settings(
            compact_transformation=True, decompose=True, eps_abs=1e-6, eps_rel=1e-6))
        return model.optimize()

    rj, rt = _both(build)
    assert rt.status == "Solved"
    Y, t = rt.x[1:].reshape(3, 3, order="F"), rt.x[0]
    assert Y[1, 0] <= 4 + 1e-4 and Y[1, 1] >= 3 - 1e-4 and Y.sum() - 12.0 >= -1e-3
    assert abs(np.linalg.svd(Y, compute_uv=False)[0] - t) <= 1e-3
    _assert_same(rj, rt, 1e-5)


def _ista_lasso(F, b, mu, iters=2000):
    """Ground truth of min ||Fv - b||^2 + mu ||v||_1 (proximal gradient)."""
    L = 2.0 * np.linalg.norm(F, 2) ** 2
    v = np.zeros(F.shape[1])
    for _ in range(iters):
        w = v - 2.0 * F.T @ (F @ v - b) / L
        v = np.sign(w) * np.maximum(np.abs(w) - mu / L, 0.0)
    return np.sum((F @ v - b) ** 2) + mu * np.abs(v).sum()


def test_socp_lasso():
    """The SOCP form of the lasso (socp-lasso.jl) against proximal
    gradient."""
    rng = np.random.default_rng(12345)
    n, m = 8, 400
    F = rng.random((m, n))
    vtrue = np.where(rng.random(n) < 0.1, rng.random(n), 0.0)
    b = F @ vtrue + 0.1 * rng.random(m)
    mu = 0.1 * np.linalg.norm(F.T @ b, np.inf)
    A1 = -np.block([
        [np.ones((1, 1)), np.zeros((1, 2 * n + 1)), np.ones((1, 1)), np.zeros((1, m))],
        [-np.ones((1, 1)), np.zeros((1, 2 * n)), np.ones((1, 1)), np.zeros((1, m + 1))],
        [np.zeros((m, 1)), -2 * F, np.zeros((m, n + 2)), np.eye(m)],
    ])
    A2 = -np.block([
        [np.zeros((n, 1)), np.eye(n), -np.eye(n), np.zeros((n, m + 2))],
        [np.zeros((n, 1)), -np.eye(n), -np.eye(n), np.zeros((n, m + 2))],
    ])
    A3 = -np.block([
        [np.zeros((1, 2 * n + 1)), -np.ones((1, 1)), np.zeros((1, m + 1))],
        [np.zeros((1, 2 * n + 2)), -np.ones((1, 1)), np.zeros((1, m))],
        [np.zeros((m, 2 * n + 3)), -np.eye(m)],
    ])
    q = np.concatenate([[1.0], np.zeros(n), mu * np.ones(n), np.zeros(m + 2)])

    def build(mod):
        model = _model(mod)
        model.assemble(np.zeros((len(q), len(q))), q, [
            mod.Constraint(A1, np.concatenate([[1.0, 1.0], -2 * b]), mod.ZeroSet(A1.shape[0])),
            mod.Constraint(A2, np.zeros(2 * n), mod.Nonnegatives(A2.shape[0])),
            mod.Constraint(A3, np.zeros(m + 2), mod.SecondOrderCone(A3.shape[0])),
        ], settings=mod.Settings(eps_abs=1e-6, eps_rel=1e-6))
        return model.optimize()

    rj, rt = _both(build)
    assert rt.status == "Solved"
    ref = _ista_lasso(F, b, mu)
    assert abs(rt.obj_val - ref) < 1e-2 * max(1.0, abs(ref))
    _assert_same(rj, rt, 1e-5)


def _box_qp(A, b, q, l, u, **settings):
    def build(mod):
        model = _model(mod)
        model.assemble(np.eye(2) if not settings.pop("zero_p", False) else np.zeros((2, 2)),
                       q, [mod.Constraint(sp.csr_matrix(A), b, mod.Box(l, u))],
                       settings=mod.Settings(**settings))
        return model.optimize()
    return build


def test_qp_box_feasible():
    """qp-box.jl, feasible: obj* = -0.5."""
    rj, rt = _both(lambda mod: _box_qp(np.eye(2), np.zeros(2), np.array([1.0, -1.0]),
                                       [0.0, 0.0], [1.0, 1.0], eps_abs=1e-7,
                                       eps_rel=1e-7)(mod))
    assert rt.status == "Solved" and abs(rt.obj_val + 0.5) < 1e-5
    _assert_same(rj, rt, 1e-6)


def test_qp_box_primal_infeasible():
    """qp-box.jl: rows 1 and 2 force x1 = -2 and x1 in [0, 1]."""
    rj, rt = _both(lambda mod: _box_qp(np.array([[1.0, 0.0], [1.0, 0.0]]),
                                       np.array([2.0, 0.0]), np.array([1.0, -1.0]),
                                       [0.0, 0.0], [1.0, 1.0])(mod))
    assert rj.status == rt.status == "Primal_infeasible"


@pytest.mark.parametrize("scaling", [0, 10])
def test_qp_box_dual_infeasible(scaling):
    """qp-box.jl: x2 unbounded below inside a half-open box, unscaled and
    scaled."""
    rj, rt = _both(lambda mod: _box_qp(np.eye(2), np.array([1.0, 1.0]), np.array([1.0, 1.0]),
                                       np.array([0.0, -np.inf]), np.array([1.0, 3.0]),
                                       zero_p=True, check_infeasibility=20,
                                       scaling=scaling)(mod))
    assert rj.status == rt.status == "Dual_infeasible"


def test_nuclear_norm_matrix_completion():
    """min ||X||_* s.t. X = M = a b' through the SDP min (tr U + tr V)/2,
    [U X; X' V] PSD: recovers M with ||X||_* = ||a|| ||b||."""
    rng = np.random.default_rng(7)
    p = r = 4
    a, bb = rng.standard_normal(p), rng.standard_normal(r)
    M = np.outer(a, bb)
    d2 = 2 * p
    nvar = d2 * (d2 + 1) // 2

    def tri(i, j):
        i, j = min(i, j), max(i, j)
        return j * (j + 1) // 2 + i

    q = np.zeros(nvar)
    for i in range(d2):
        q[tri(i, i)] = 0.5
    A_eq = np.zeros((p * r, nvar))
    for k, (i, j) in enumerate((i, j) for i in range(p) for j in range(r)):
        A_eq[k, tri(i, p + j)] = 1.0 / np.sqrt(2.0)
    b_eq = M.ravel()

    def build(mod):
        model = _model(mod)
        model.assemble(np.zeros((nvar, nvar)), q, [
            mod.Constraint(A_eq, -b_eq, mod.ZeroSet(A_eq.shape[0])),
            mod.Constraint(np.eye(nvar), np.zeros(nvar), mod.PsdConeTriangle(nvar))],
            settings=mod.Settings(eps_abs=1e-7, eps_rel=1e-7, decompose=False))
        return model.optimize()

    rj, rt = _both(build)
    assert rt.status == "Solved"
    np.testing.assert_allclose(smat(rt.x)[:p, p:], M, atol=5e-4)
    assert abs(rt.obj_val - np.linalg.norm(a) * np.linalg.norm(bb)) < 1e-3
    _assert_same(rj, rt, 1e-6)


# ---- tests/test_fuzz.py -----------------------------------------------------

def _solve_both(*args, **kw):
    return ct.solve(*args, **kw), pt.solve(*args, device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_lp_vs_highs(seed):
    from scipy.optimize import linprog

    rng = np.random.default_rng(seed)
    n, m = 12, 20
    c = rng.standard_normal(n)
    A_ub = rng.standard_normal((m, n))
    b_ub = A_ub @ rng.random(n) + rng.random(m)
    ref = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=[(0, 10.0)] * n, method="highs")
    assert ref.status == 0
    A = np.vstack([A_ub, -np.eye(n), np.eye(n)])
    b = np.concatenate([b_ub, np.zeros(n), np.full(n, 10.0)])
    rj, rt = _solve_both(None, c, A, b, {"l": m + 2 * n}, eps_abs=1e-8, eps_rel=1e-8)
    assert rt.status == "Solved"
    assert abs(rt.obj_val - ref.fun) < 1e-5 * max(1.0, abs(ref.fun))
    _assert_same(rj, rt, 1e-6)


@pytest.mark.parametrize("seed", [10, 11])
def test_random_qp_kkt(seed):
    rng = np.random.default_rng(seed)
    n, m = 10, 16
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    rj, rt = _solve_both(P, q, A, b, {"l": m}, eps_abs=1e-9, eps_rel=1e-9)
    assert rt.status == "Solved"
    x, y, s = rt.x, rt.y, rt.s
    assert np.abs(P @ x + q + A.T @ y).max() < 1e-5
    assert np.abs(A @ x + s - b).max() < 1e-6
    assert s.min() > -1e-7 and y.min() > -1e-7 and np.abs(y * s).max() < 1e-5
    _assert_same(rj, rt, 1e-7)


def test_random_socp_kkt():
    rng = np.random.default_rng(42)
    n = 6
    c = np.concatenate([[1.0], rng.standard_normal(n - 1) * 0.1])
    bsoc = np.zeros(n)
    bsoc[0] = 1.0
    G = rng.standard_normal((4, n))
    A = np.vstack([-np.eye(n), G])
    b = np.concatenate([bsoc, np.ones(4)])

    def build(mod):
        model = _model(mod, mod.Settings(eps_abs=1e-9, eps_rel=1e-9))
        model.set(np.zeros((n, n)), c, A, b, [mod.SecondOrderCone(n), mod.Nonnegatives(4)])
        return model.optimize()

    rj, rt = _both(build)
    assert rt.status == "Solved"
    assert np.linalg.norm(rt.s[1:n]) <= rt.s[0] + 1e-6
    assert (b[n:] - A[n:] @ rt.x).min() > -1e-6
    _assert_same(rj, rt, 1e-7)


def test_infeasible_lp_detected():
    """x <= 0 and x >= 1: Primal_infeasible, through solve and Model."""
    n = 4
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.concatenate([np.zeros(n), -np.ones(n)])
    rj, rt = _solve_both(None, np.ones(n), A, b, {"l": 2 * n}, max_iter=4000)
    assert rj.status == rt.status == "Primal_infeasible"


def test_unbounded_lp_detected():
    """min -1'x, x >= 0: Dual_infeasible."""
    n = 3

    def build(mod):
        model = _model(mod, mod.Settings(max_iter=4000))
        model.set(np.zeros((n, n)), -np.ones(n), -np.eye(n), np.zeros(n),
                  [mod.Nonnegatives(n)])
        return model.optimize()

    rj, rt = _both(build)
    assert rj.status == rt.status == "Dual_infeasible"
