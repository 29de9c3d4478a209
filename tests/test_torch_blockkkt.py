"""The block-diagonal KKT of cosmo_tpu_torch (ops/blockkkt.py) against
cosmo_tpu.ops.blockkkt, float64 on the CPU: the same structure analysis,
and — on the reference's own meta and operators, carried across by
cosmo_tpu_torch.convert — the same factors and solves for the same seeded
right-hand sides and rho, to 1e-10."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
from cosmo_tpu import chordal as jch
from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import blockkkt as jbk
from cosmo_tpu.ops import linops as jl
from cosmo_tpu_torch import convert
from cosmo_tpu_torch.ops import blockkkt as tbk

from _torch_port import as_numpy_dict

torch.set_num_threads(1)
F64 = torch.float64
TOL = 1e-10


def _decomposed(n_nodes=200, bandwidth=8):
    info = jch.decompose(*jprob.banded_sdp(n_nodes, bandwidth, sparse=True)[:5],
                         ct.Settings())
    P, _, A, _, _ = info.problem
    return sp.csr_matrix(P), sp.csr_matrix(A)


def _block_sdp():
    """block_sdp's P = I and its A decouple at this size."""
    P, _, A, _, _ = jprob.block_sdp(n_blocks=12, side=8, n=48, seed=0)
    return sp.csr_matrix(P), sp.csr_matrix(A)


PROBLEMS = {"decomposed_banded": _decomposed, "block_sdp": _block_sdp}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_analyze_matches_reference(name):
    P, A = PROBLEMS[name]()
    jm, tm = jbk.analyze(P, A, max_block=64), tbk.analyze(P, A, max_block=64)
    assert jm is not None and tm is not None
    assert jm.n == tm.n and len(jm.buckets) == len(tm.buckets)
    for jb, tb in zip(jm.buckets, tm.buckets):
        for f in dataclasses.fields(tb):
            a, b = getattr(jb, f.name), getattr(tb, f.name)
            if b is None or isinstance(b, int):
                assert a == b, f.name
            else:
                assert np.array_equal(np.asarray(a), b), f.name


def test_analyze_rejects_coupled_problems():
    A = sp.csr_matrix(np.random.default_rng(0).normal(size=(30, 20)))
    P = sp.csr_matrix((20, 20))
    assert jbk.analyze(P, A, max_block=16) is None
    assert tbk.analyze(P, A, max_block=16) is None


def _both(name, seed=0, dense_A=True):
    """The reference's meta, operators, state and a seeded rhs, and the
    port's counterparts carried across. ``dense_A=False`` drops the
    block-dense A (row_ids) so the unfused applies run."""
    P, A = PROBLEMS[name]()
    m, n = A.shape
    jm = jbk.analyze(P, A, max_block=64)
    if not dense_A:
        jm = dataclasses.replace(jm, buckets=tuple(
            dataclasses.replace(b, R=0, row_ids=None) for b in jm.buckets))
    Pj, Aj = jl.coo_from_scipy(P, np.float64), jl.coo_from_scipy(A, np.float64)
    rng = np.random.default_rng(seed)
    rho = np.abs(rng.normal(1.0, 0.3, m)) + 0.1
    sigma = 1e-6
    r1, r2 = rng.normal(size=n), rng.normal(size=m)
    js = jbk.factor(jm, Pj, Aj, sigma, jnp.asarray(rho))
    tm = convert.blockkkt_meta_from_dict(as_numpy_dict(jm), "cpu")
    Pt = convert.coo_from_dict(as_numpy_dict(Pj), "cpu", F64)
    At = convert.coo_from_dict(as_numpy_dict(Aj), "cpu", F64)
    ts = tbk.factor(tm, Pt, At, torch.tensor(sigma, dtype=F64), torch.as_tensor(rho))
    return dict(jm=jm, js=js, Pj=Pj, Aj=Aj, tm=tm, ts=ts, Pt=Pt, At=At, rho=rho,
                sigma=sigma, r1=r1, r2=r2, m=m)


def _close(a, b):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_factor_and_solves_match_reference(name):
    d = _both(name)
    for (jMinv, jAd, jrhog), (tMinv, tAd, trhog) in zip(d["js"], d["ts"]):
        _close(jMinv, tMinv)
        _close(jAd, tAd)
        _close(jrhog, trhog)
    rho, r1, r2 = torch.as_tensor(d["rho"]), torch.as_tensor(d["r1"]), torch.as_tensor(d["r2"])
    jx, jnu = jbk.solve(d["jm"], d["js"], d["Pj"], d["Aj"], d["sigma"],
                        jnp.asarray(d["rho"]), jnp.asarray(d["r1"]), jnp.asarray(d["r2"]))
    tx, tnu = tbk.solve(d["tm"], d["ts"], d["Pt"], d["At"], torch.tensor(d["sigma"], dtype=F64),
                        rho, r1, r2)
    _close(jx, tx)
    _close(jnu, tnu)
    # the block-space solve on the same r1 in block layout
    jcols = jbk.blockspace_cols(d["jm"])
    tcols = tbk.blockspace_cols(d["tm"])
    assert np.array_equal(np.asarray(jcols), tcols.numpy())
    assert jbk.blockspace_dim(d["jm"]) == tbk.blockspace_dim(d["tm"])
    r1g = np.concatenate([d["r1"], [0.0]])[np.asarray(jcols)]
    jxg, jnu2 = jbk.solve_blockspace(d["jm"], d["js"], jnp.asarray(d["rho"]),
                                     jnp.asarray(r1g), jnp.asarray(d["r2"]))
    txg, tnu2 = tbk.solve_blockspace(d["tm"], d["ts"], rho, torch.as_tensor(r1g), r2)
    _close(jxg, txg)
    _close(jnu2, tnu2)
    # block space is a padded permutation of the n-space solution
    back = torch.zeros(d["tm"].n + 1, dtype=F64)
    back[tcols] = txg
    _close(jx, back[:-1])


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_block_applies_match_reference(name):
    """The applies through the cached inverses and the block-dense A."""
    d = _both(name, seed=1)
    n = d["tm"].n
    x = np.random.default_rng(2).normal(size=n)
    y = np.random.default_rng(3).normal(size=d["m"])
    _close(jbk._apply(d["jm"], d["js"], jnp.asarray(x)),
           tbk._apply(d["tm"], d["ts"], torch.as_tensor(x)))
    _close(jbk._block_matvec(d["jm"], d["js"], jnp.asarray(x), d["m"]),
           tbk._block_matvec(d["tm"], d["ts"], torch.as_tensor(x), d["m"]))
    _close(jbk._block_rmatvec(d["jm"], d["js"], jnp.asarray(y)),
           tbk._block_rmatvec(d["tm"], d["ts"], torch.as_tensor(y)))


def test_unfused_solve_without_block_dense_A():
    """Buckets without the block-dense A (a skewed rows-per-component
    layout) solve through the COO applies and the cached inverses."""
    d = _both("decomposed_banded", seed=4, dense_A=False)
    assert all(Ad is None for _, Ad, _ in d["ts"])
    assert not tbk.supports_blockspace(d["tm"])
    jx, jnu = jbk.solve(d["jm"], d["js"], d["Pj"], d["Aj"], d["sigma"],
                        jnp.asarray(d["rho"]), jnp.asarray(d["r1"]), jnp.asarray(d["r2"]))
    tx, tnu = tbk.solve(d["tm"], d["ts"], d["Pt"], d["At"], torch.tensor(d["sigma"], dtype=F64),
                        torch.as_tensor(d["rho"]), torch.as_tensor(d["r1"]),
                        torch.as_tensor(d["r2"]))
    _close(jx, tx)
    _close(jnu, tnu)


def test_non_factorizable_block_gives_nan_inverse():
    """A block without a Cholesky factor (indefinite P on its columns) gets
    a NaN inverse, as JAX's cholesky gives, and the other blocks stay
    finite; the solve then ends Unsolved instead of raising."""
    P, A = _block_sdp()
    n = P.shape[0]
    P = sp.csr_matrix(P.toarray() - 200.0 * np.diag(np.arange(n) < 4))
    jm, tm = jbk.analyze(P, A), tbk.meta_to_device(tbk.analyze(P, A), "cpu")
    rho = np.full(A.shape[0], 0.1)
    js = jbk.factor(jm, jl.coo_from_scipy(P, np.float64), jl.coo_from_scipy(A, np.float64),
                    1e-6, jnp.asarray(rho))
    ts = tbk.factor(tm, *(convert.coo_from_dict(as_numpy_dict(jl.coo_from_scipy(M, np.float64)),
                                                "cpu", F64) for M in (P, A)),
                    torch.tensor(1e-6, dtype=F64), torch.as_tensor(rho))
    bad_j = np.concatenate([np.isnan(np.asarray(s[0])).any(axis=(1, 2)) for s in js])
    bad_t = np.concatenate([torch.isnan(s[0]).any(dim=2).any(dim=1).numpy() for s in ts])
    assert bad_t.any() and not bad_t.all()
    assert np.array_equal(bad_j, bad_t)
