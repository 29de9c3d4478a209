"""The amortized and jacobi_mm PSD backends of cosmo_tpu_torch against
cosmo_tpu, in float64 on the CPU.

The plain versions of ``cosmo_tpu_torch.ops.eigh`` (``jacobi_eigh`` with its
methods and starting basis, ``psd_project_amortized``,
``min_max_eig_jacobi``) are held to the JAX functions on the same seeded
inputs within 1e-10 of max |X|; the amortized projection must also make the
same full-or-warm sweep decision. Then solves: ports of tests/test_eigh.py's
amortized and Jacobi tests, parity of the amortized solve with the
reference's, its chunked solve against the uninterrupted one, a primal
infeasible SDP under the amortized backend (the certificate shadow projects
from a fresh basis). The sides of the large kernel and odd sides are in
tests/test_torch_eigh_large.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import eigh as jeigh
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch import solver as tsolver
from cosmo_tpu_torch.models.model import refine_hint
from cosmo_tpu_torch.ops import eigh as teigh
from cosmo_tpu_torch.ops import jacobi_eig
from cosmo_tpu_torch.settings import split_settings

from _torch_port import sym_stack

torch.set_num_threads(1)


def _near(got, ref, scale, tol=1e-10):
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err <= tol * scale, err


def _orthogonal_near(B, k, seed, angle=0.05):
    """A stack of orthogonal matrices a few small rotations from I."""
    G = np.random.default_rng(seed).standard_normal((B, k, k)) * angle
    Q, _ = np.linalg.qr(np.eye(k) + (G - G.swapaxes(1, 2)))
    return Q


@pytest.mark.parametrize("method,with_v0,tensor_sweeps", [
    ("vec", False, False), ("mm", False, False), ("vecT", False, False),
    ("vec", True, False), ("mm", True, True), ("vec", False, True),
], ids=["vec", "mm", "vecT", "vec_V0", "mm_V0_tensor_sweeps", "vec_tensor_sweeps"])
@pytest.mark.parametrize("B,k", [(6, 8), (3, 16), (2, 6)])
def test_jacobi_eigh_matches_reference(method, with_v0, tensor_sweeps, B, k):
    """jacobi_eigh(X, 5, method, V0) against the JAX function: w and V
    within 1e-10 of max |X| (V0 an orthogonal basis near I; the sweep count
    an int or a 0-d tensor)."""
    X = sym_stack(B, k, seed=10 * k + B)
    V0 = _orthogonal_near(B, k, seed=k) if with_v0 else None
    sweeps = torch.tensor(5) if tensor_sweeps else 5
    jw, jV = jeigh.jacobi_eigh(jnp.asarray(X), 5, method,
                               V0=None if V0 is None else jnp.asarray(V0))
    tw, tV = teigh.jacobi_eigh(torch.as_tensor(X), sweeps, method,
                               V0=None if V0 is None else torch.as_tensor(V0))
    scale = np.abs(X).max()
    _near(tw.numpy(), jw, scale)
    _near(tV.numpy(), jV, 1.0)


@pytest.mark.parametrize("method", ["vec", "mm"])
def test_psd_project_jacobi_and_min_max_eig_match_reference(method):
    X = sym_stack(5, 12, seed=3)
    ref = jeigh.psd_project_jacobi(jnp.asarray(X), 8, method)
    got = teigh.psd_project_jacobi(torch.as_tensor(X), 8, method)
    _near(got.numpy(), ref, np.abs(X).max())
    jmin, jmax = jeigh.min_max_eig_jacobi(jnp.asarray(X), 8, method)
    tmin, tmax = teigh.min_max_eig_jacobi(torch.as_tensor(X), 8, method)
    _near(tmin.numpy(), jmin, np.abs(X).max())
    _near(tmax.numpy(), jmax, np.abs(X).max())


def _reference_decision(X, V):
    """Whether the JAX amortized projection ran the full sweeps on (X, V):
    its output equals the one with both counts set to the full sweeps (8),
    and not the one with both at the warm (2)."""
    Xj, Vj = jnp.asarray(X), jnp.asarray(V)
    P, _ = jeigh.psd_project_amortized(Xj, Vj, warm_sweeps=2, full_sweeps=8)
    P_full, _ = jeigh.psd_project_amortized(Xj, Vj, warm_sweeps=8, full_sweeps=8)
    P_warm, _ = jeigh.psd_project_amortized(Xj, Vj, warm_sweeps=2, full_sweeps=2)
    full, warm = bool(jnp.all(P == P_full)), bool(jnp.all(P == P_warm))
    assert full != warm
    return full


@pytest.mark.parametrize("case", ["identity", "warm", "stale_one_block", "jump"])
def test_psd_project_amortized_matches_reference(case):
    """The plain amortized projection against the JAX function: the same
    sweep decision, and P and V within 1e-10 of max |X|. ``identity``: the
    first projection (stale); ``warm``: the carry from a projection of X a
    1e-3 drift before (warm); ``stale_one_block``: the same, but one block
    of eight jumped (any stale block makes the whole bucket stale); ``jump``:
    every block jumped."""
    B, k = 8, 16
    rng = np.random.default_rng(7)
    X = sym_stack(B, k, seed=4)
    V = np.broadcast_to(np.eye(k), (B, k, k)).copy()
    if case != "identity":
        _, Vj = jeigh.psd_project_amortized(jnp.asarray(X), jnp.asarray(V), 2, 10)
        V = np.array(Vj)
        D = rng.standard_normal((B, k, k)) * 1e-3
        X = X + (D + D.swapaxes(1, 2)) / 2
        if case == "stale_one_block":
            X[3] = sym_stack(1, k, seed=99)[0] * 2.0
        elif case == "jump":
            X = X + 2.0 * sym_stack(B, k, seed=98)
    full = _reference_decision(X, V)
    assert full == (case != "warm")
    _, _, stale = teigh.amortized_rotate(torch.as_tensor(X), torch.as_tensor(V))
    assert bool(stale) == full
    jP, jV = jeigh.psd_project_amortized(jnp.asarray(X), jnp.asarray(V), 2, 8)
    tP, tV = jacobi_eig.psd_project_amortized(torch.as_tensor(X), torch.as_tensor(V), 2, 8)
    _near(tP.numpy(), jP, np.abs(X).max())
    _near(tV.numpy(), jV, 1.0)


def test_amortized_projection_tracks_slow_drift():
    """tests/test_eigh.py::test_amortized_projection_tracks_slow_drift in
    the port: the amortized projection (warm 2, full 10) matches a fresh
    LAPACK eigendecomposition within 5e-7 while the input drifts slowly,
    across a sudden jump at step 12 (the staleness fallback)."""
    rng = np.random.default_rng(3)
    B, k = 8, 16
    M = rng.standard_normal((B, k, k))
    X = torch.as_tensor((M + np.transpose(M, (0, 2, 1))) / 2)
    V = torch.eye(k, dtype=torch.float64).expand(B, k, k).clone()
    D = rng.standard_normal((B, k, k)) * 0.01
    D = torch.as_tensor((D + np.transpose(D, (0, 2, 1))) / 2)
    for step in range(25):
        if step == 12:
            J = rng.standard_normal((B, k, k)) * 2.0
            X = X + torch.as_tensor((J + np.transpose(J, (0, 2, 1))) / 2)
        P, V = jacobi_eig.psd_project_amortized(X, V, warm_sweeps=2, full_sweeps=10)
        w, Q = np.linalg.eigh(X.numpy())
        P_ref = np.einsum("bik,bk,bjk->bij", Q, np.maximum(w, 0.0), Q)
        err = np.abs(P.numpy() - P_ref).max()
        assert err < 5e-7, (step, err)
        X = X + D


def _block_sdp_model(mod, backend, **kw):
    P, q, A, b, sets = (jprob if mod is ct else tprob).block_sdp(
        n_blocks=12, side=8, n=48, seed=5)
    settings = mod.Settings(eps_abs=1e-7, eps_rel=1e-7, eigh_backend=backend,
                            jacobi_sweeps=10, **kw)
    model = mod.Model(settings) if mod is ct else mod.Model(settings, device="cpu")
    return model.set(P, q, A, b, sets)


def test_amortized_backend_end_to_end():
    """tests/test_eigh.py::test_amortized_backend_end_to_end in the port
    (the amortized backend against the xla one on block_sdp(12, 8, 48)),
    and the amortized solve against the reference's: the same status and
    the objective within 1e-6 relative."""
    res = {be: _block_sdp_model(pt, be).optimize() for be in ("xla", "amortized")}
    assert all(r.status == "Solved" for r in res.values())
    assert abs(res["amortized"].obj_val - res["xla"].obj_val) < 1e-5
    np.testing.assert_allclose(res["amortized"].x, res["xla"].x, rtol=1e-4, atol=1e-5)
    rj = _block_sdp_model(ct, "amortized").optimize()
    assert rj.status == res["amortized"].status
    assert abs(rj.obj_val - res["amortized"].obj_val) <= 1e-6 * abs(rj.obj_val)


def test_jacobi_mm_backend_matches_reference():
    """tests/test_eigh.py::test_solver_with_jacobi_backend with the
    packed-rotation method: closest_correlation(n=10) with
    eigh_backend="jacobi_mm" in both packages, and against the xla backend
    of the port; objectives within 1e-4, x within 1e-4."""
    def run(mod, backend):
        P, q, A, b, sets, _ = (jprob if mod is ct else tprob).closest_correlation(
            n=10, seed=0)
        s = mod.Settings(eps_abs=1e-6, eps_rel=1e-6, eigh_backend=backend)
        model = mod.Model(s) if mod is ct else mod.Model(s, device="cpu")
        return model.set(P, q, A, b, sets).optimize()

    rj, rt, r0 = run(ct, "jacobi_mm"), run(pt, "jacobi_mm"), run(pt, "xla")
    assert rj.status == rt.status == r0.status == "Solved"
    assert abs(rt.obj_val - rj.obj_val) < 1e-4 and abs(rt.obj_val - r0.obj_val) < 1e-4
    assert np.allclose(rt.x, rj.x, atol=1e-4) and np.allclose(rt.x, r0.x, atol=1e-4)


def test_amortized_chunked_solve_matches_uninterrupted():
    """The eigenbasis rides the resumable carry: solve_chunked in chunks of
    15 iterations lands on the uninterrupted amortized solve bit for bit."""
    mt = _block_sdp_model(pt, "amortized", check_termination=5)
    rt = mt.optimize()
    dev = mt._dev_cache
    m, n = mt.model_size
    static, dyn = split_settings(mt._resolved_settings, m, n, torch.float64,
                                 refine_hint=refine_hint(mt.sets), device="cpu")
    args = (dev["Pd"], dev["Ad"], dev["qd"], dev["bd"], dev["cones"],
            dev["x0"], dev["s0"], dev["mu0"])
    plain = tsolver.solve(*args, dyn, static)
    chunked = tsolver.solve_chunked(*args, dyn, static, chunk=15)
    assert chunked["status"] == plain["status"] == 1
    assert plain["iter"] > 30
    assert chunked["iter"] == plain["iter"] == rt.iter - rt.safeguarding_iter
    assert np.array_equal(chunked["x"], plain["x"]) and np.array_equal(plain["x"], rt.x)
    assert np.array_equal(chunked["y"], plain["y"])


def test_amortized_primal_infeasible_sdp():
    """tr(X) = -1 with X PSD (side 4) is primal infeasible: under the
    amortized backend both packages end Primal_infeasible. The certificate
    shadow's projections start from the identity basis each time."""
    def build(mod):
        svec = (jprob if mod is ct else tprob).svec
        r, d = 4, 10
        cons = [mod.Constraint(svec(np.eye(r))[None, :], [1.0], mod.ZeroSet),
                mod.Constraint(np.eye(d), np.zeros(d), mod.PsdConeTriangle)]
        s = mod.Settings(eigh_backend="amortized", decompose=False)
        model = mod.Model(s) if mod is ct else mod.Model(s, device="cpu")
        return model.assemble(np.zeros((d, d)), svec(np.eye(r)), cons)

    rj, rt = build(ct).optimize(), build(pt).optimize()
    assert rj.status == rt.status == "Primal_infeasible"

