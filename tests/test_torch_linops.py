"""cosmo_tpu_torch.ops.linops against cosmo_tpu.ops.linops in float64.

The block-dense-row and COO constructors are host-side numpy copies, so
their fields must be identical. The matvecs and reductions run different libraries (XLA vs
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


def test_coo_from_scipy_fields_identical():
    A, _ = _block_matrix()
    jc, tc = jl.coo_from_scipy(A, np.float64), tl.coo_from_scipy(A, np.float64)
    for f in dataclasses.fields(tc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if isinstance(tv, np.ndarray):
            assert np.array_equal(np.asarray(jv), tv), f.name
        else:
            assert jv == tv, f.name
    assert np.all(np.diff(tc.rows) >= 0) and np.all(np.diff(tc.ccols) >= 0)


def _pair(kind, with_sel=True):
    """The same operator in both packages: the JAX one and the port's,
    the port's Bde and Coo carried across with convert."""
    A, rb = _block_matrix()
    if kind == "dense":
        Ad = A.toarray()
        return jnp.asarray(Ad), torch.as_tensor(Ad)
    if kind == "coo":
        jc = jl.coo_from_scipy(A, np.float64)
        return jc, convert.coo_from_dict(as_numpy_dict(jc), "cpu", F64)
    jb = jl.bde_from_scipy(A, rb, sel_budget_bytes=(64 << 20) if with_sel else 0)
    jb = jb.__class__(**{f.name: (jnp.asarray(getattr(jb, f.name))
                                  if isinstance(getattr(jb, f.name), np.ndarray)
                                  else getattr(jb, f.name))
                         for f in dataclasses.fields(jb)})
    return jb, convert.bde_from_dict(as_numpy_dict(jb), "cpu", F64)


CASES = [("dense", True), ("bde", True), ("bde", False), ("coo", True)]


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
    close(jl.diag_AtRhoA(jA, jnp.asarray(rho)), tl.diag_AtRhoA(tA, torch.as_tensor(rho)))
    if kind == "coo":
        # a Coo A goes through the block-diagonal KKT, never the dense one
        with pytest.raises(TypeError):
            tl.AtRhoA(tA, torch.as_tensor(rho))
    else:
        close(jl.AtRhoA(jA, jnp.asarray(rho)), tl.AtRhoA(tA, torch.as_tensor(rho)))
    js = jl.scale_rows_cols(jA, jnp.asarray(ew), jnp.asarray(dw))
    ts = tl.scale_rows_cols(tA, torch.as_tensor(ew), torch.as_tensor(dw))
    x = rng.standard_normal(n)
    close(jl.matvec(js, jnp.asarray(x)), tl.matvec(ts, torch.as_tensor(x)))
    js = jl.scale_all(jl.scale_rows(jA, jnp.asarray(ew)), 0.3)
    ts = tl.scale_all(tl.scale_rows(tA, torch.as_tensor(ew)), 0.3)
    y = rng.standard_normal(m)
    close(jl.rmatvec(js, jnp.asarray(y)), tl.rmatvec(ts, torch.as_tensor(y)))


@pytest.mark.parametrize("kind", ["dense", "coo"])
def test_square_operator_helpers_match(kind):
    """diag_part and symmetrize on a symmetric P with empty rows and
    columns (a Coo is taken as symmetric already, as in the reference)."""
    rng = np.random.default_rng(4)
    Pd = np.zeros((12, 12))
    Pd[2:9, 2:9] = rng.standard_normal((7, 7))
    Pd = Pd + Pd.T
    if kind == "dense":
        jP, tP = jnp.asarray(Pd), torch.as_tensor(Pd)
    else:
        jP = jl.coo_from_scipy(sp.csr_matrix(Pd), np.float64)
        tP = convert.coo_from_dict(as_numpy_dict(jP), "cpu", F64)
    assert np.abs(np.asarray(jl.diag_part(jP)) - tl.diag_part(tP).numpy()).max() <= TOL
    assert np.array_equal(tl.diag_part(tP).numpy(), np.diag(Pd))
    x = rng.standard_normal(12)
    assert np.abs(np.asarray(jl.matvec(jl.symmetrize(jP), jnp.asarray(x)))
                  - tl.matvec(tl.symmetrize(tP), torch.as_tensor(x)).numpy()).max() <= TOL
    assert np.array_equal(tl.colmax_abs(tP).numpy(), np.abs(Pd).max(axis=0))


def test_coo_segment_sums_match_index_add():
    """A Coo's products, diagonal and weighted column sums
    (ops/linops._coo_segment_sum) take torch.segment_reduce over the
    segment pointers for a copy whose widest segment reaches
    SEGMENT_REDUCE_WIDTH (here the rows, with one long row) and index_add_
    over the sorted ids for the other (the columns): on the CPU both bit
    for bit the sums of index_add_ (the reference's segment_sum), with
    empty rows and columns, and A @ x within 1e-14 of scipy's."""
    rng = np.random.default_rng(0)
    width = tl.SEGMENT_REDUCE_WIDTH + 20
    A = sp.lil_matrix(sp.random(60, width, density=0.1, random_state=3))
    A[5, :] = rng.standard_normal(width)                   # a long row
    A[7, :] = 0.0
    A[:, 9] = 0.0
    A = sp.csr_matrix(A)
    P = sp.csr_matrix(sp.random(40, 40, density=0.1, random_state=4) + sp.eye(40))
    c, cp = (tl.coo_to_device(tl.coo_from_scipy(M, np.float64), "cpu", torch.float64)
             for M in (A, P))
    assert c.max_row_nnz >= tl.SEGMENT_REDUCE_WIDTH > c.max_col_nnz
    x = torch.as_tensor(rng.standard_normal(width))
    y, rho = torch.as_tensor(rng.standard_normal(60)), torch.as_tensor(rng.random(60) + 0.5)
    on_diag = torch.where(cp.rows == cp.cols, cp.vals, torch.zeros_like(cp.vals))
    for got, ref in (
            (tl.matvec(c, x), tl._segment_sum(c.vals * x[c.cols], c.rows, 60)),
            (tl.rmatvec(c, y), tl._segment_sum(c.cvals * y[c.crows], c.ccols, width)),
            (tl.diag_part(cp), tl._segment_sum(on_diag, cp.rows, 40)),
            (tl.diag_AtRhoA(c, rho),
             tl._segment_sum(rho[c.crows] * c.cvals * c.cvals, c.ccols, width))):
        assert torch.equal(got, ref)
    assert np.abs(tl.matvec(c, x).numpy() - A @ x.numpy()).max() <= 1e-14
