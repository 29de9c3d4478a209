"""cosmo_tpu_torch.ops.linops against cosmo_tpu.ops.linops in float64.

The block-dense-row constructor is a host-side numpy copy, so its fields must
be identical. The matvecs and reductions run different libraries (XLA vs
PyTorch CPU kernels) over the same f64 data; their sums are short (at most
n terms of O(1) values), so they agree to 1e-12."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import linops as jl
from cosmo_tpu_torch import convert
from cosmo_tpu_torch.ops import linops as tl

from _torch_port import as_numpy_dict

torch.set_num_threads(1)
TOL = 1e-12
F64 = torch.float64


def _block_matrix():
    _, _, A, _, _ = jprob.block_sdp(n_blocks=9, side=4, n=40, seed=3, density=0.15)
    return sp.csr_matrix(A), 10          # rows per group = tri_dim(4)


@pytest.mark.parametrize("with_sel", [True, False])
def test_bde_from_scipy_fields_identical(with_sel):
    A, rb = _block_matrix()
    budget = 64 << 20 if with_sel else 0
    jb = jl.bde_from_scipy(A, rb, sel_budget_bytes=budget)
    tb = tl.bde_from_scipy(A, rb, sel_budget_bytes=budget)
    assert (jb.sel is None) == (tb.sel is None) == (not with_sel)
    for f in dataclasses.fields(tb):
        jv, tv = getattr(jb, f.name), getattr(tb, f.name)
        if isinstance(tv, np.ndarray):
            assert np.array_equal(np.asarray(jv), tv), f.name
        else:
            assert jv == tv, f.name


def test_bde_from_scipy_rejects_like_reference():
    A, rb = _block_matrix()
    assert jl.bde_from_scipy(A, rb + 1) is None and tl.bde_from_scipy(A, rb + 1) is None
    assert jl.bde_from_scipy(A, rb, max_cmax=2) is None
    assert tl.bde_from_scipy(A, rb, max_cmax=2) is None


def _pair(kind, with_sel=True):
    """The same operator in both packages: the JAX one and the port's,
    the port's Bde carried across with convert.bde_from_dict."""
    A, rb = _block_matrix()
    if kind == "dense":
        Ad = A.toarray()
        return jnp.asarray(Ad), torch.as_tensor(Ad)
    jb = jl.bde_from_scipy(A, rb, sel_budget_bytes=(64 << 20) if with_sel else 0)
    jb = jb.__class__(**{f.name: (jnp.asarray(getattr(jb, f.name))
                                  if isinstance(getattr(jb, f.name), np.ndarray)
                                  else getattr(jb, f.name))
                         for f in dataclasses.fields(jb)})
    return jb, convert.bde_from_dict(as_numpy_dict(jb), "cpu", F64)


CASES = [("dense", True), ("bde", True), ("bde", False)]


@pytest.mark.parametrize("kind,with_sel", CASES)
def test_matvec_rmatvec_match(kind, with_sel):
    jA, tA = _pair(kind, with_sel)
    m, n = jA.shape
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(n), rng.standard_normal(m)
    assert np.abs(np.asarray(jl.matvec(jA, jnp.asarray(x)))
                  - tl.matvec(tA, torch.as_tensor(x)).numpy()).max() <= TOL
    assert np.abs(np.asarray(jl.rmatvec(jA, jnp.asarray(y)))
                  - tl.rmatvec(tA, torch.as_tensor(y)).numpy()).max() <= TOL
    # against the scipy matrix itself
    A, _ = _block_matrix()
    assert np.abs(tl.matvec(tA, torch.as_tensor(x)).numpy() - A @ x).max() <= TOL
    assert np.abs(tl.rmatvec(tA, torch.as_tensor(y)).numpy() - A.T @ y).max() <= TOL


@pytest.mark.parametrize("kind,with_sel", CASES)
def test_reductions_and_scalings_match(kind, with_sel):
    jA, tA = _pair(kind, with_sel)
    m, n = jA.shape
    rng = np.random.default_rng(1)
    ew, dw = rng.random(m) + 0.5, rng.random(n) + 0.5
    rho = rng.random(m) + 0.1

    def close(j, t):
        assert np.abs(np.asarray(j) - t.numpy()).max() <= TOL

    close(jl.colmax_abs(jA), tl.colmax_abs(tA))
    close(jl.rowmax_abs(jA), tl.rowmax_abs(tA))
    close(jl.AtRhoA(jA, jnp.asarray(rho)), tl.AtRhoA(tA, torch.as_tensor(rho)))
    js = jl.scale_rows_cols(jA, jnp.asarray(ew), jnp.asarray(dw))
    ts = tl.scale_rows_cols(tA, torch.as_tensor(ew), torch.as_tensor(dw))
    x = rng.standard_normal(n)
    close(jl.matvec(js, jnp.asarray(x)), tl.matvec(ts, torch.as_tensor(x)))
    js = jl.scale_all(jl.scale_rows(jA, jnp.asarray(ew)), 0.3)
    ts = tl.scale_all(tl.scale_rows(tA, torch.as_tensor(ew)), 0.3)
    y = rng.standard_normal(m)
    close(jl.rmatvec(js, jnp.asarray(y)), tl.rmatvec(ts, torch.as_tensor(y)))
