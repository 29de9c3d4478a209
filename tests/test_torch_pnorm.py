"""l1.5 regression through power cones, cosmo_tpu_torch against cosmo_tpu,
on the CPU in float64.

min_w ||Z w - y||_p with 400 power cones K_pow(2/3), in two constructions
of the MOSEK Modeling Cookbook: the sum of powers
(``problems.pnorm_regression``: |r_i|^p <= u_i as (u_i, 1, r_i), minimising
sum_i u_i = ||r||_p^p; ``chip_smoke.py`` phase 9d solves it at a9a's shape
on the card) and the p-norm cone (:func:`pnorm_cone_form`, built here:
minimise t, sum_i s_i = t, (s_i, t, r_i) in every cone; at a9a's shape it
is PERF.md's open question, which ``pnorm_shared_t.py`` beside this file
reproduces). Here at 400 x 12 (4 features set a row; the port's plain pow
projection reads the host every Newton step, so the size stays small), in
both constructions: both packages must reach Solved at eps 1e-5, their
weights' ||Z w - y||_p within 1e-8 of ``problems.pnorm_optimum``
(L-BFGS-B on the host), and each objective within twice its own duality
gap |q'x + b'y| of the construction's optimum (||r||_p^p or ||r||_p), plus
1e-6 of it (the rule of phase 9a). Iteration counts are not compared.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu_torch import problems as tprob

torch.set_num_threads(1)
N, D, NNZ, P_NORM = 400, 12, 4, 1.5
FORMS = {"sum of powers": False, "shared t": True}


def pnorm_cone_form(Z, y, p):
    """min_w ||Z w - y||_p by the p-norm cone: minimise t subject to sum_i
    s_i = t and (s_i, t, r_i) in K_pow(1/p) (so s_i >= |r_i|^p / t^(p-1)
    and t >= ||r||_p), over x = [w (d); t; s (N)]; one ZeroSet row first,
    then each sample's three rows, every cone sharing t. Returns (P, q, A,
    b, sets) in the port's sets."""
    N, d = Z.shape
    i = np.arange(N)
    Zc = sp.coo_matrix(Z)
    c1 = 1 + 3 * i                       # the first row of sample i's cone
    # b - A x: (sum s - t), then (s_i, t, z_i'w - y_i)
    rows = np.concatenate([c1, c1[Zc.row] + 2, np.zeros(N, int), [0], c1 + 1])
    cols = np.concatenate([d + 1 + i, Zc.col, d + 1 + i, [d], np.full(N, d)])
    vals = np.concatenate([-np.ones(N), -Zc.data, np.ones(N), [-1.0], -np.ones(N)])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(1 + 3 * N, d + 1 + N))
    b = np.zeros(1 + 3 * N)
    b[c1 + 2] = -y
    q = np.zeros(d + 1 + N)
    q[d] = 1.0
    sets = [pt.ZeroSet(1)] + [pt.PowerCone(1.0 / p) for _ in range(N)]
    return sp.csr_matrix((d + 1 + N, d + 1 + N)), q, A, b, sets


@pytest.fixture(scope="module", params=list(FORMS))
def problem(request):
    shared_t = FORMS[request.param]
    P, q, A, b, sets, (Z, y) = tprob.pnorm_regression(N, D, NNZ, P_NORM, seed=0)
    if shared_t:
        P, q, A, b, sets = pnorm_cone_form(Z, y, P_NORM)
    return shared_t, (P, q, A, b, sets, (Z, y))


@pytest.fixture(scope="module")
def optimum():
    *_, (Z, y) = tprob.pnorm_regression(N, D, NNZ, P_NORM, seed=0)
    return tprob.pnorm_optimum(Z, y, P_NORM)


def test_pnorm_model_structure(problem):
    """x = [w; u] (400 power cones) or [w; t; s] (a ZeroSet row, then 400
    power cones), every cone K_pow(2/3); at w, and u_i = |r_i|^p (or t =
    ||r||_p and s_i = |r_i|^p / t^(p-1)), the rows b - A x lie in the
    sets, each cone on its boundary."""
    shared_t, (P, q, A, b, sets, (Z, y)) = problem
    first = int(shared_t)
    assert sp.issparse(A) and A.shape == (first + 3 * N, D + first + N) and P.nnz == 0
    assert sp.issparse(Z) and Z.nnz == N * NNZ
    assert len(sets) == first + N
    assert all(type(s).__name__ == "PowerCone" and s.alpha == 1.0 / P_NORM
               for s in sets[first:])
    w = np.random.default_rng(1).standard_normal(D)
    r = np.asarray(Z @ w).ravel() - y
    if shared_t:
        assert type(sets[0]).__name__ == "ZeroSet" and sets[0].dim == 1
        assert q.tolist() == [0.0] * D + [1.0] + [0.0] * N
        t = np.sum(np.abs(r) ** P_NORM) ** (1.0 / P_NORM)
        s = np.abs(r) ** P_NORM / t ** (P_NORM - 1.0)
        slack = b - A @ np.concatenate([w, [t], s])
        assert abs(slack[0]) <= 1e-12 * t
        second = np.full(N, t)
    else:
        assert q.tolist() == [0.0] * D + [1.0] * N
        s = np.abs(r) ** P_NORM
        slack = b - A @ np.concatenate([w, s])
        second = np.ones(N)
    rows = slack[first:].reshape(N, 3)
    np.testing.assert_allclose(rows[:, :2], np.stack([s, second], 1), rtol=1e-15)
    np.testing.assert_allclose(rows[:, 2], r, rtol=1e-15)
    a = 1.0 / P_NORM
    np.testing.assert_allclose(rows[:, 0] ** a * rows[:, 1] ** (1 - a), np.abs(r), rtol=1e-12)


def test_pnorm_optimum_is_stationary(optimum):
    """The L-BFGS-B optimum: the gradient of sum_i |r_i|^p at its w is at
    most 1e-8 of the sum, and no coordinate step of 1e-6 lowers ||r||_p."""
    *_, (Z, y) = tprob.pnorm_regression(N, D, NNZ, P_NORM, seed=0)
    f, w = optimum
    r = np.asarray(Z @ w).ravel() - y
    g = np.asarray(Z.T @ (P_NORM * np.abs(r) ** (P_NORM - 1) * np.sign(r))).ravel()
    assert np.abs(g).max() <= 1e-8 * np.sum(np.abs(r) ** P_NORM)
    assert f == tprob.pnorm_loss(Z, y, P_NORM, w)
    for j in range(D):
        for h in (-1e-6, 1e-6):
            e = np.zeros(D)
            e[j] = h
            assert tprob.pnorm_loss(Z, y, P_NORM, w + e) >= f * (1 - 1e-15)


@pytest.mark.parametrize("package", ["cosmo_tpu", "cosmo_tpu_torch"])
def test_pnorm_solves_to_the_optimum(problem, optimum, package):
    shared_t, (P, q, A, b, sets, (Z, y)) = problem
    f_opt, _ = optimum
    obj_opt = f_opt if shared_t else f_opt ** P_NORM
    if package == "cosmo_tpu":
        jsets = ([ct.ZeroSet(1)] * shared_t
                 + [ct.PowerCone(1.0 / P_NORM) for _ in range(N)])
        model = ct.Model(ct.Settings(eps_abs=1e-5, eps_rel=1e-5)).set(P, q, A, b, jsets)
    else:
        model = pt.Model(pt.Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64),
                         device="cpu").set(P, q, A, b, sets)
    res = model.optimize()
    assert res.status == "Solved"
    x = np.asarray(res.x)
    loss = tprob.pnorm_loss(Z, y, P_NORM, x[:D])
    assert abs(loss - f_opt) <= 1e-8 * f_opt
    gap = abs(q @ x + b @ np.asarray(res.y))
    assert abs(res.obj_val - obj_opt) <= 2.0 * gap + 1e-6 * obj_opt
