"""Mixed precision, custom KKT solvers and the logistic-regression model of
cosmo_tpu_torch against cosmo_tpu, on the CPU in float64: ports of
tests/test_options.py:265 (the mixed-precision loose phase) and :140-167
(a KKT plug-in through the AbstractKKTSolver contract), and the model of
examples/logistic_regression.py built by ``problems.logistic_regression``.

On the CPU both precisions of the loose phase are the same arithmetic, so
the solves with and without it must agree; the latch's iteration is
checked. Results are held to the JAX package's within 10 times eps.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob

torch.set_num_threads(1)


def test_mixed_precision_loose_phase():
    """mixed_precision=True runs the loose phase until the relative
    residuals reach mixed_precision_switch, then latches off; on the CPU
    the result equals the plain configuration's and the JAX package's."""
    res = {}
    for mod, prob in ((ct, jprob), (pt, tprob)):
        P, q, A, b, sets = prob.block_sdp(n_blocks=8, side=8, n=32, seed=1)
        for mp in (False, True):
            s = mod.Settings(eps_abs=1e-7, eps_rel=1e-7, eigh_backend="polar",
                             mixed_precision=mp)
            kw = dict(device="cpu") if mod is pt else {}
            model = mod.Model(s, **kw).set(P, q, A, b, sets)
            r = model.optimize()
            assert r.status == "Solved", (mod.__name__, mp)
            res[mod, mp] = (r, model)
    rt, mt = res[pt, True]
    np.testing.assert_allclose(rt.x, res[pt, False][0].x, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rt.x, res[ct, True][0].x, rtol=1e-6, atol=1e-8)
    assert 0 < mt.last_solve["loose_iter"] <= rt.iter
    assert res[pt, False][1].last_solve["loose_iter"] == -1


def _kkt_plugin(mod):
    """A dense-inverse KKT solver in the package's own tensor library."""
    if mod is ct:
        def setup(Pm, Am, sigma, rho_vec):
            n = Pm.shape[0]
            return jnp.linalg.inv(Pm + sigma * jnp.eye(n, dtype=Pm.dtype)
                                  + Am.T @ (rho_vec[:, None] * Am))

        def solve(Minv, Pm, Am, sigma, rho_vec, r1, r2):
            x = Minv @ (r1 + Am.T @ (rho_vec * r2))
            return x, rho_vec * (Am @ x - r2)
    else:
        def setup(Pm, Am, sigma, rho_vec):
            n = Pm.shape[0]
            return Pm + sigma * torch.eye(n, dtype=Pm.dtype, device=Pm.device) + Am.T @ (
                rho_vec[:, None] * Am)

        def solve(M, Pm, Am, sigma, rho_vec, r1, r2):
            x = torch.linalg.solve(M, r1 + Am.T @ (rho_vec * r2))
            return x, rho_vec * (Am @ x - r2)
    return mod.CustomKKTSolver(setup=setup, solve=solve)


def _options_qp(mod):
    rng = np.random.default_rng(7)
    n, m = 8, 12
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, [mod.Nonnegatives(m)]


def test_custom_kkt_solver_matches_builtin():
    """A plug-in solving the KKT system with torch.linalg.solve reproduces
    the built-in dense solve, as the JAX package's plug-in does; a plug-in
    without solve is refused."""
    res = {}
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        for name, kkt in (("custom", _kkt_plugin(mod)), ("dense", "dense")):
            model = mod.Model(mod.Settings(eps_abs=1e-8, eps_rel=1e-8, kkt_solver=kkt), **kw)
            res[mod, name] = model.set(*_options_qp(mod)).optimize()
    assert res[pt, "custom"].status == "Solved"
    np.testing.assert_allclose(res[pt, "custom"].x, res[pt, "dense"].x, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res[pt, "custom"].x, res[ct, "custom"].x, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError):
        pt.CustomKKTSolver(setup=len)


def test_custom_kkt_solver_phase_timers():
    """verbose_timing times the plug-in's setup and solve."""
    model = pt.Model(pt.Settings(verbose_timing=True, kkt_solver=_kkt_plugin(pt)),
                     device="cpu").set(*_options_qp(pt))
    t = model.optimize().times
    assert t.init_factor_time > 0 and t.update_time > 0
    assert np.isfinite(t.factor_update_time)


# ---- the logistic-regression model -----------------------------------------

def _example_model(N=30, d=3, lam=0.1, seed=3):
    """examples/logistic_regression.py's model, built as the example builds
    it, with the JAX package."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((N, d))
    w_true = rng.standard_normal(d)
    y = np.sign(Z @ w_true + 0.3 * rng.standard_normal(N))
    nvar = d + 3 * N
    P = np.zeros((nvar, nvar))
    P[:d, :d] = 2 * lam * np.eye(d)
    q = np.concatenate([np.zeros(d), np.ones(N), np.zeros(2 * N)])
    cons = []
    for i in range(N):
        A1, b1 = np.zeros((3, nvar)), np.zeros(3)
        A1[0, :d] = -y[i] * Z[i]
        A1[0, d + i] = -1.0
        b1[1] = 1.0
        A1[2, d + 2 * N + i] = 1.0
        cons.append(ct.Constraint(A1, b1, ct.ExponentialCone()))
        A2, b2 = np.zeros((3, nvar)), np.zeros(3)
        A2[0, d + i] = -1.0
        b2[1] = 1.0
        A2[2, d + N + i] = 1.0
        cons.append(ct.Constraint(A2, b2, ct.ExponentialCone()))
    A3 = np.zeros((N, nvar))
    A3[:, d + N: d + 2 * N] = -np.eye(N)
    A3[:, d + 2 * N:] = -np.eye(N)
    cons.append(ct.Constraint(A3, np.ones(N), ct.Nonnegatives))
    model = ct.Model(ct.Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=10000))
    model.assemble(P, q, cons)
    return model, (Z, y)


def test_logistic_model_is_the_example_and_solves_as_reference():
    """problems.logistic_regression(30, 3, lam=0.1, seed=3) is the
    example's assembled model (same P, q, A, b and sets, A sparse); the
    port solves it as the JAX package solves the example (eps 1e-6, within
    1e-5), its weights' loss within 1e-6 of logistic_optimum."""
    mj, (Z, y) = _example_model()
    P, q, A, b, sets, (Zt, yt) = tprob.logistic_regression(30, 3, None, lam=0.1, seed=3)
    np.testing.assert_array_equal(Zt, Z)
    np.testing.assert_array_equal(yt, y)
    assert sp.issparse(A)
    np.testing.assert_array_equal(A.toarray(), mj.A)
    np.testing.assert_array_equal(P.toarray(), mj.P)
    np.testing.assert_array_equal(q, mj.q)
    np.testing.assert_array_equal(b, mj.b)
    assert [type(s).__name__ for s in sets] == [type(s).__name__ for s in mj.sets]
    rj = mj.optimize()
    rt = pt.Model(pt.Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=10000),
                  device="cpu").set(P, q, A, b, sets).optimize()
    assert rj.status == rt.status == "Solved"
    assert abs(rt.obj_val - rj.obj_val) <= 1e-5 * abs(rj.obj_val)
    assert np.abs(rt.x[:3] - rj.x[:3]).max() <= 1e-5 * np.abs(rj.x[:3]).max()
    f_opt, w_opt = tprob.logistic_optimum(Z, y, 0.1)
    loss, _ = tprob.logistic_loss(Z, y, 0.1, rt.x[:3])
    assert abs(loss - f_opt) <= 1e-6 * f_opt


def test_logistic_optimum_against_reference():
    """logistic_optimum on an a9a-shaped sparse binary problem (200 samples,
    123 features, 14 set a sample): its gradient is within 1e-10 and the
    JAX package's eps-1e-8 solve of the conic model lands on it (loss within
    1e-8, weights within 1e-4); at eps 1e-5 the conic objective sits
    within twice the duality gap of the optimum in both packages."""
    P, q, A, b, sets, (Z, y) = tprob.logistic_regression(200, 123, 14, lam=0.5, seed=0)
    assert sp.issparse(Z) and Z.nnz == 200 * 14
    f_opt, w_opt = tprob.logistic_optimum(Z, y, 0.5)
    _, g = tprob.logistic_loss(Z, y, 0.5, w_opt)
    assert np.abs(g).max() <= 1e-10
    jsets = [ct.Nonnegatives(200)] + [ct.ExponentialCone() for _ in range(400)]
    for eps in (1e-8, 1e-5):
        runs = [ct.Model(ct.Settings(eps_abs=eps, eps_rel=eps)).set(P, q, A, b, jsets)]
        if eps == 1e-5:
            runs.append(pt.Model(pt.Settings(eps_abs=eps, eps_rel=eps), device="cpu").set(
                P, q, A, b, sets))
        for model in runs:
            r = model.optimize()
            assert r.status == "Solved"
            loss, _ = tprob.logistic_loss(Z, y, 0.5, r.x[:123])
            if eps == 1e-8:
                assert abs(loss - f_opt) <= 1e-8 * f_opt
                assert np.abs(r.x[:123] - w_opt).max() <= 1e-4 * np.abs(w_opt).max()
            x = r.x
            gap = abs((x @ (P @ x) + q @ x) + b @ r.y)
            assert abs(r.obj_val - f_opt) <= 2.0 * gap + 1e-9 * f_opt


def test_loose_phase_products_are_three_tf32_parts():
    """The loose phase's products split each float32 operand into a part
    TF32 holds exactly and an exact float32 rest (on the CPU the three
    products are float32, so the polar moves by ~the dropped lo*lo term:
    within 1e-6 of max |X|); float64 ignores the flag."""
    from cosmo_tpu_torch.ops import eigh as E

    G = torch.as_tensor(np.random.default_rng(3).standard_normal((6, 24, 24)),
                        dtype=torch.float32)
    X = (G + G.transpose(1, 2)) / 2
    hi, lo = E._tf32_split(X)
    assert torch.equal(hi + lo, X)
    assert int((hi.view(torch.int32) & E._TF32_LOW_BITS).abs().max()) == 0
    assert (lo.abs() <= 2.0 ** -10 * X.abs()).all()
    err = (E.psd_project_polar(X, tf32=True) - E.psd_project_polar(X)).abs().max()
    assert float(err) <= 1e-6 * float(X.abs().max())
    X64 = X.double()
    assert torch.equal(E.psd_project_polar(X64, tf32=True), E.psd_project_polar(X64))
