"""Conic problems with known solutions through cosmo_tpu_torch against
cosmo_tpu, on the CPU in float64: ports of tests/test_conic.py (SOCP, SDP,
closest correlation, exponential, dual exponential and power cones, mixed
cones), tests/test_custom_cone.py (user cones) and
tests/test_complex_psd.py (the complex Hermitian PSD cone).

Each problem goes through both packages at the original test's settings;
the port must reach the original's known answer and match the JAX
package's status, objective, x, y and s within 10 times the solve's eps
(relative to the larger of 1 and the largest entry). Iteration counts are
never compared (ROADMAP.md "How the port is held").
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt

torch.set_num_threads(1)


def _both(build, **settings):
    """(JAX result, port result) of ``build(mod, model)`` in each package."""
    rj = build(ct, ct.Model(ct.Settings(**settings))).optimize()
    rt = build(pt, pt.Model(pt.Settings(**settings), device="cpu")).optimize()
    return rj, rt


def _assert_same(rj, rt, tol):
    assert rj.status == rt.status
    if rj.status == "Solved":
        assert abs(rj.obj_val - rt.obj_val) <= tol * max(1.0, abs(rj.obj_val))
        for a in ("x", "y", "s"):
            ja, ta = getattr(rj, a), getattr(rt, a)
            assert ja.shape == ta.shape
            assert np.abs(ja - ta).max() <= tol * max(1.0, np.abs(ja).max()), a


def _svec(X):
    r = X.shape[0]
    return np.array([X[i, j] * (1.0 if i == j else np.sqrt(2.0))
                     for j in range(r) for i in range(j + 1)])


def _svec_pairs(r):
    return [(i, j) for j in range(r) for i in range(j + 1)]


# ---- tests/test_conic.py --------------------------------------------------

def test_socp():
    """min x3 s.t. ||(x1, x2)|| <= x3, x1 + x2 = 2 -> (1, 1, sqrt 2)."""
    def build(mod, model):
        cons = [mod.Constraint([[1.0, 1.0, 0.0]], [-2.0], mod.ZeroSet),
                mod.Constraint(np.array([[0.0, 0, 1], [1, 0, 0], [0, 1, 0]]), np.zeros(3),
                               mod.SecondOrderCone)]
        return model.assemble(np.zeros((3, 3)), np.array([0.0, 0.0, 1.0]), cons)

    rj, rt = _both(build)
    assert rt.status == "Solved"
    np.testing.assert_allclose(rt.x, [1.0, 1.0, np.sqrt(2.0)], atol=1e-3)
    _assert_same(rj, rt, 1e-4)


def test_min_eigenvalue_sdp():
    """min tr(CX) s.t. tr(X) = 1, X PSD -> lambda_min(C)."""
    r = 5
    nsv = r * (r + 1) // 2
    Cs = np.random.default_rng(12345).normal(size=(r, r))
    Cm = 0.5 * (Cs + Cs.T)
    tr_row = np.array([1.0 if i == j else 0.0 for (i, j) in _svec_pairs(r)])

    def build(mod, model):
        cons = [mod.Constraint(tr_row.reshape(1, -1), [-1.0], mod.ZeroSet),
                mod.Constraint(np.eye(nsv), np.zeros(nsv), mod.PsdConeTriangle(nsv))]
        return model.assemble(np.zeros((nsv, nsv)), _svec(Cm), cons,
                              settings=mod.Settings(decompose=False))

    rj, rt = _both(build)
    assert rt.status == "Solved"
    assert abs(rt.obj_val - np.linalg.eigvalsh(Cm).min()) < 1e-3
    _assert_same(rj, rt, 1e-4)


def test_closest_correlation_matrix():
    """min ||X - C||_F^2 s.t. diag(X) = 1, X PSD (closestcorr.jl)."""
    r = 8
    nsv = r * (r + 1) // 2
    Cs = np.random.default_rng(7).normal(size=(r, r))
    Cm = 0.5 * (Cs + Cs.T)
    diag_rows = np.zeros((r, nsv))
    for k, (i, j) in enumerate(_svec_pairs(r)):
        if i == j:
            diag_rows[i, k] = 1.0

    def build(mod, model):
        cons = [mod.Constraint(diag_rows, -np.ones(r), mod.ZeroSet),
                mod.Constraint(np.eye(nsv), np.zeros(nsv), mod.PsdConeTriangle(nsv))]
        return model.assemble(2.0 * np.eye(nsv), -2.0 * _svec(Cm), cons,
                              settings=mod.Settings(decompose=False))

    rj, rt = _both(build)
    assert rt.status == "Solved"
    X = np.zeros((r, r))
    for k, (i, j) in enumerate(_svec_pairs(r)):
        X[i, j] = X[j, i] = rt.x[k] * (1.0 if i == j else 1 / np.sqrt(2))
    np.testing.assert_allclose(np.diag(X), np.ones(r), atol=1e-4)
    assert np.linalg.eigvalsh(X).min() > -1e-5
    _assert_same(rj, rt, 1e-4)


def test_exp_cone():
    """max x s.t. (x, 1, e^5) in K_exp -> x* = 5."""
    def build(mod, model):
        con = mod.Constraint(np.array([[1.0], [0.0], [0.0]]), np.array([0.0, 1.0, np.exp(5.0)]),
                             mod.ExponentialCone())
        return model.assemble(np.zeros((1, 1)), np.array([-1.0]), [con],
                              settings=mod.Settings(eps_abs=1e-6, eps_rel=1e-6))

    rj, rt = _both(build)
    assert rt.status == "Solved"
    assert abs(rt.x[0] - 5.0) < 1e-3
    _assert_same(rj, rt, 1e-5)


def test_dual_exp_cone():
    """min y s.t. (-e, y, 1) in K_exp^* -> y* = 0."""
    def build(mod, model):
        con = mod.Constraint(np.array([[0.0], [1.0], [0.0]]), np.array([-np.e, 0.0, 1.0]),
                             mod.DualExponentialCone())
        return model.assemble(np.zeros((1, 1)), np.array([1.0]), [con])

    rj, rt = _both(build)
    assert rt.status == "Solved"
    assert abs(rt.x[0]) < 1e-3
    _assert_same(rj, rt, 1e-4)


@pytest.mark.parametrize("alpha", [0.3, 0.6])
def test_pow_cone(alpha):
    """max z s.t. (2, 3, z) in K_pow(alpha) -> z* = 2^a 3^(1-a)."""
    def build(mod, model):
        con = mod.Constraint(np.array([[0.0], [0.0], [1.0]]), np.array([2.0, 3.0, 0.0]),
                             mod.PowerCone(alpha))
        return model.assemble(np.zeros((1, 1)), np.array([-1.0]), [con])

    rj, rt = _both(build)
    assert rt.status == "Solved"
    assert abs(rt.x[0] - 2.0 ** alpha * 3.0 ** (1 - alpha)) < 1e-3
    _assert_same(rj, rt, 1e-4)


def test_mixed_cones():
    """Zero + Nonnegatives + Box + SOC in one problem."""
    n = 4
    rng = np.random.default_rng(12345)
    Ps = rng.normal(size=(n, n))
    P = Ps @ Ps.T + 0.1 * np.eye(n)
    q = rng.normal(size=n)

    def build(mod, model):
        cons = [
            mod.Constraint(np.ones((1, n)), [-1.0], mod.ZeroSet),
            mod.Constraint(np.eye(n), np.ones(n), mod.Nonnegatives),
            mod.Constraint(np.eye(n), np.zeros(n),
                           mod.Box(-2 * np.ones(n), 2 * np.ones(n))),
            mod.Constraint(np.vstack([np.zeros((1, n)), np.eye(n)]),
                           np.concatenate([[10.0], np.zeros(n)]), mod.SecondOrderCone),
        ]
        return model.assemble(P, q, cons)

    rj, rt = _both(build)
    assert rt.status == "Solved"
    assert abs(np.sum(rt.x) - 1.0) < 1e-4 and np.all(rt.x >= -1 - 1e-4)
    _assert_same(rj, rt, 1e-4)


# ---- tests/test_custom_cone.py --------------------------------------------

def _qp():
    rng = np.random.default_rng(0)
    n, m = 8, 12
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, m


def _nonneg_custom(mod, m):
    """The nonnegative orthant as a user cone, with its membership tests
    and support function, in each package's tensor library."""
    if mod is ct:
        return ct.CustomCone(
            dim=m, project=lambda v: jnp.maximum(v, 0.0),
            in_pol_recc=lambda v, tol: jnp.all(v <= tol),
            support=lambda y, tol: jnp.where(jnp.all(y <= tol), 0.0, jnp.inf),
            scalar_scaling=False)
    return pt.CustomCone(
        dim=m, project=lambda v: torch.clamp(v, min=0.0),
        in_pol_recc=lambda v, tol: (v <= tol).all(),
        support=lambda y, tol: torch.where((y <= tol).all(), 0.0, float("inf")),
        scalar_scaling=False)


def test_custom_nonneg_matches_builtin():
    """A user cone for the nonnegative orthant solves as the built-in cone,
    twice on one model, in both packages."""
    P, q, A, b, m = _qp()
    res = {}
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        m1 = mod.Model(mod.Settings(eps_abs=1e-8, eps_rel=1e-8), **kw)
        m1.set(P, q, A, b, [_nonneg_custom(mod, m)])
        m0 = mod.Model(mod.Settings(eps_abs=1e-8, eps_rel=1e-8), **kw)
        m0.set(P, q, A, b, [mod.Nonnegatives(m)])
        res[mod] = (m1.optimize(), m1.optimize(), m0.optimize())
    r1, r1b, r0 = res[pt]
    assert r1.status == "Solved"
    assert np.abs(r1.x - r0.x).max() < 1e-7 and np.abs(r1b.x - r0.x).max() < 1e-7
    _assert_same(res[ct][0], r1, 1e-6)


def _soc_project(mod):
    def jax_project(v):
        t, x = v[0], v[1:]
        nx = jnp.linalg.norm(x)
        scale = jnp.clip((nx + t) / 2.0, 0.0, None)
        safe = jnp.where(nx > 0, nx, 1.0)
        proj = jnp.concatenate([scale[None], (scale / safe) * x])
        return jnp.where(nx <= t, v, jnp.where(nx <= -t, jnp.zeros_like(v), proj))

    def torch_project(v):
        t, x = v[0], v[1:]
        nx = torch.linalg.vector_norm(x)
        scale = torch.clamp((nx + t) / 2.0, min=0.0)
        safe = torch.where(nx > 0, nx, torch.ones_like(nx))
        proj = torch.cat([scale[None], (scale / safe) * x])
        return torch.where(nx <= t, v, torch.where(nx <= -t, torch.zeros_like(v), proj))

    return jax_project if mod is ct else torch_project


def test_custom_second_order_cone_mixed():
    """A user SOC beside built-in cones solves as the built-in SOC."""
    P, q, A, b, m = _qp()
    d = 4
    res = {}
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        m1 = mod.Model(mod.Settings(eps_abs=1e-8, eps_rel=1e-8), **kw)
        m1.set(P, q, A, b, [mod.Nonnegatives(m - d),
                            mod.CustomCone(dim=d, project=_soc_project(mod))])
        m0 = mod.Model(mod.Settings(eps_abs=1e-8, eps_rel=1e-8), **kw)
        m0.set(P, q, A, b, [mod.Nonnegatives(m - d), mod.SecondOrderCone(d)])
        res[mod] = (m1.optimize(), m0.optimize())
    r1, r0 = res[pt]
    assert r1.status == "Solved"
    assert np.abs(r1.x - r0.x).max() < 1e-6
    _assert_same(res[ct][0], r1, 1e-6)


# ---- tests/test_complex_psd.py --------------------------------------------

def pack_hermitian(H):
    r = H.shape[0]
    re = [H[i, j].real * (1.0 if i == j else np.sqrt(2.0))
          for j in range(r) for i in range(j + 1)]
    im = [H[i, j].imag * np.sqrt(2.0) for j in range(r) for i in range(j)]
    return np.array(re + im)


def _proj_ref(H):
    w, V = np.linalg.eigh(H)
    return (V * np.maximum(w, 0.0)) @ V.conj().T


def _hermitian(r, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((r, r)) + 1j * rng.standard_normal((r, r))
    return (G + G.conj().T) / 2


def test_hermitian_projection_through_solver():
    """min 1/2 ||x - pack(H)||^2 s.t. x in the Hermitian PSD cone ->
    pack(Pi(H)), through the real 10 x 10 embedding."""
    H = _hermitian(5, 0)
    v, dim = pack_hermitian(H), 25

    def build(mod, model):
        return model.set(np.eye(dim), -v, -np.eye(dim), np.zeros(dim),
                         [mod.PsdConeTriangleComplex(dim)])

    rj, rt = _both(build, eps_abs=1e-8, eps_rel=1e-8, decompose=False)
    assert rt.status == "Solved"
    assert np.abs(rt.x - pack_hermitian(_proj_ref(H))).max() < 1e-6
    _assert_same(rj, rt, 1e-6)


def test_hermitian_1x1_reduces_to_nonneg():
    def build(mod, model):
        return model.set(np.eye(1), np.array([2.0]), -np.eye(1), np.zeros(1),
                         [mod.PsdConeTriangleComplex(1)])

    rj, rt = _both(build, eps_abs=1e-8, eps_rel=1e-8)
    assert rt.status == "Solved" and abs(rt.x[0]) < 1e-6
    _assert_same(rj, rt, 1e-6)


def test_hermitian_mixed_with_real_cones():
    """The same projection with a redundant nonnegativity on the diagonal."""
    r = 3
    H = _hermitian(r, 1)
    v, dim = pack_hermitian(H), r * r
    A2 = np.zeros((r, dim))
    for k in range(r):
        A2[k, k * (k + 1) // 2 + k] = -1.0

    def build(mod, model):
        return model.set(np.eye(dim), -v, np.vstack([-np.eye(dim), A2]),
                         np.zeros(dim + r), [mod.PsdConeTriangleComplex(dim),
                                             mod.Nonnegatives(r)])

    rj, rt = _both(build, eps_abs=1e-8, eps_rel=1e-8)
    assert rt.status == "Solved"
    assert np.abs(rt.x - pack_hermitian(_proj_ref(H))).max() < 1e-5
    _assert_same(rj, rt, 1e-6)
