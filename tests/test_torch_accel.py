"""Anderson acceleration of cosmo_tpu_torch (accel.py) against
cosmo_tpu.accel, in float64 on the CPU, and the accelerator option matrix
end to end.

``update``/``accelerate``/``restart`` run on the same seeded sequence of
(x, g) pairs in both packages — every type, memory and regularizer, with
the gate absent, true and false, through a memory wrap, a rank-deficient
secant and a non-finite one — and every field agrees to 1e-10. The
sync-free rank test is held to the reference's SVD rule on Gram matrices
on either side of its threshold. The 36 accelerator combinations and the
two regularizers of tests/test_options.py solve; the objective is held to
JAX on the default combination and on one per type."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import accel as jaccel
from cosmo_tpu_torch import accel as taccel

torch.set_num_threads(1)
TOL = 1e-10
FIELDS = ("x_last", "g_last", "f_last", "dF", "dG", "count", "have_last", "active",
          "success", "n_accelerated", "best_nrm_f")


def _same(jaa, taa, w_j=None, w_t=None):
    for name in FIELDS:
        a = np.asarray(getattr(jaa, name))
        b = getattr(taa, name).numpy()
        if a.dtype.kind == "f":
            assert a.shape == b.shape, name
            assert np.allclose(a, b, rtol=TOL, atol=TOL * max(1.0, np.abs(a[np.isfinite(a)]).max(initial=0.0))), name
        else:
            assert np.array_equal(a, b), name
    if w_j is not None:
        w_j = np.asarray(w_j)
        assert np.abs(w_j - w_t.numpy()).max() <= TOL * max(1.0, np.abs(w_j).max())


def _sequence(steps, d, seed):
    """(x, g, gate) per step: random pairs; step 5 repeats step 4's secant
    (a rank-deficient history), step 9 has an infinite entry; the gate is
    absent, true or false."""
    rng = np.random.default_rng(seed)
    seq = []
    for t in range(steps):
        x = rng.standard_normal(d)
        g = 0.6 * x + 0.3 * rng.standard_normal(d)
        if t == 5:
            px, pg = seq[4][0], seq[4][1]
            ppx, ppg = seq[3][0], seq[3][1]
            x, g = px + (px - ppx), pg + (pg - ppg)
        if t == 9:
            g = g.copy()
            g[3] = np.inf
        gate = (None, True, True, False)[t % 4] if t > 1 else None
        seq.append((x, g, gate))
    return seq


@pytest.mark.parametrize("regularizer", ["none", "tikhonov", "frobenius"])
@pytest.mark.parametrize("memory", ["restarted", "rolling"])
@pytest.mark.parametrize("aa_type", ["type2", "type2_qr", "type1"])
def test_update_accelerate_restart_match(aa_type, memory, regularizer):
    d, mem = 30, 5
    jaa = jaccel.init_accel(d, mem, jnp.float64)
    taa = taccel.init_accel(d, mem, torch.float64, "cpu")
    jaa = jaa._replace(active=jnp.asarray(True))
    taa.active = torch.ones((), dtype=torch.bool)
    for t, (x, g, gate) in enumerate(_sequence(16, d, seed=0)):
        jg = None if gate is None else jnp.asarray(gate)
        tg = None if gate is None else torch.tensor(gate)
        jaa = jaccel.update(jaa, jnp.asarray(g), jnp.asarray(x), memory, gate=jg)
        taa = taccel.update(taa, torch.as_tensor(g), torch.as_tensor(x), memory, gate=tg)
        w = x + 0.01
        jw, jaa = jaccel.accelerate(jaa, jnp.asarray(w), aa_type, regularizer, gate=jg)
        tw, taa = taccel.accelerate(taa, torch.as_tensor(w), aa_type, regularizer, gate=tg)
        _same(jaa, taa, jw, tw)
        if t == 11:
            jaa, taa = jaccel.restart(jaa), taccel.restart(taa)
            _same(jaa, taa)
    # the sequence exercised both outcomes
    assert 0 < int(taa.n_accelerated) < 16


def _reference_rank_test(G, n_active, c):
    """cosmo_tpu.accel's rule: the n_active-th singular value of G clears c
    times the largest."""
    sv = np.linalg.svd(G, compute_uv=False)
    return sv[min(max(n_active - 1, 0), len(sv) - 1)] > c * sv[0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetric", [True, False])
def test_sync_free_rank_test_matches_svd_rule(dtype, symmetric):
    """The sync-free rank test (accel._well_conditioned) against the SVD
    rule on masked Gram matrices with condition numbers 0.3 and 3 times the
    threshold 1/(eps mem), and 1e3, exactly singular and all zero."""
    mem = 15
    c = float(np.finfo(dtype).eps) * mem
    rng = np.random.default_rng(7)
    for n_active in (1, 4, 11, 15):
        for kappa in (1e3, 0.3 / c, 3.0 / c, np.inf, 0.0):
            U, _ = np.linalg.qr(rng.standard_normal((n_active, n_active)))
            V, _ = np.linalg.qr(rng.standard_normal((n_active, n_active)))
            if kappa == 0.0:
                s = np.zeros(n_active)
            elif np.isinf(kappa):
                s = np.logspace(0, -3, n_active)
                s[-1] = 0.0 if n_active > 1 else 1.0
            else:
                s = np.logspace(0, -np.log10(kappa), n_active) if n_active > 1 else np.ones(1)
            Ga = (U * s) @ (U.T if symmetric else V.T)
            G = np.zeros((mem, mem))
            G[:n_active, :n_active] = Ga
            G = G.astype(dtype)
            want = _reference_rank_test(G.astype(np.float64), n_active, c)
            active = torch.arange(mem) < n_active
            got = taccel._well_conditioned(torch.as_tensor(G), active,
                                           torch.tensor(n_active, dtype=torch.int32), c)
            assert bool(got) == bool(want), (n_active, kappa)


def _qp(mod):
    rng = np.random.default_rng(7)
    n, m = 8, 12
    M = rng.standard_normal((n, n))
    P = M @ M.T / n + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m)
    return P, q, A, b, [mod.Nonnegatives(m)]


def _solve(mod, **kw):
    model = (ct.Model(ct.Settings(**kw)) if mod is ct
             else pt.Model(pt.Settings(**kw), device="cpu"))
    return model.set(*_qp(mod)).optimize()


# the objective is held to JAX on these combinations
HELD = {("type2", "restarted", "immediate", True), ("type2_qr", "restarted", "immediate", True),
        ("type1", "restarted", "immediate", True)}


@pytest.mark.parametrize("aa_type", ["type2", "type2_qr", "type1"])
@pytest.mark.parametrize("memory", ["restarted", "rolling"])
@pytest.mark.parametrize("activation", ["immediate", "iter", "accuracy"])
@pytest.mark.parametrize("safeguard", [True, False])
def test_accelerator_combinations_solve(aa_type, memory, activation, safeguard):
    """The accelerator matrix of tests/test_options.py (reference:
    anderson_accelerator.jl asserts :Solved for every combination)."""
    kw = dict(eps_abs=1e-7, eps_rel=1e-7, accelerator_type=aa_type,
              accelerator_memory=memory, accelerator_activation=activation,
              safeguard=safeguard)
    rt = _solve(pt, **kw)
    assert rt.status == "Solved"
    if (aa_type, memory, activation, safeguard) in HELD:
        rj = _solve(ct, **kw)
        assert rj.status == "Solved"
        assert abs(rt.obj_val - rj.obj_val) <= 1e-6 * max(1.0, abs(rj.obj_val))


@pytest.mark.parametrize("regularizer", ["tikhonov", "frobenius"])
def test_accelerator_regularizers_solve(regularizer):
    rt = _solve(pt, eps_abs=1e-7, eps_rel=1e-7, accelerator_regularizer=regularizer)
    assert rt.status == "Solved"
