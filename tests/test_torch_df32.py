"""The compensated double-f32 arithmetic of cosmo_tpu_torch (ops/df32.py)
and the refined half of the block-diagonal KKT (ops/blockkkt.py) against
cosmo_tpu, in float32 on the CPU.

The error-free transformations must be exact: checked in float64 on float32
inputs. Every compensated result — the matvecs (dense, Coo, Bde), the KKT
right-hand side and residual, the pair-valued block assembly, the refined
solves and the compensated residuals — is held both to the JAX function on
the same inputs and to a float64 evaluation of the same float32 data, to
within 2 float32 ulps relative to the result's largest entry."""
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
from cosmo_tpu.ops import df32 as jdf
from cosmo_tpu.ops import linops as jl
from cosmo_tpu_torch import convert
from cosmo_tpu_torch.ops import blockkkt as tbk
from cosmo_tpu_torch.ops import df32 as tdf
from cosmo_tpu_torch.ops import kkt as tkkt
from cosmo_tpu_torch.ops import linops as tl

from _torch_port import as_numpy_dict

torch.set_num_threads(1)
F32 = torch.float32
EPS32 = float(np.finfo(np.float32).eps)
ULPS = 2.0


def _ulps(got, ref):
    """max |got - ref| in float32 ulps of max |ref| (float64 arithmetic)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / (EPS32 * max(np.abs(ref).max(), 1e-300))


def _pair64(pair):
    """A (hi, lo) pair (torch or JAX) collapsed in float64."""
    h, lo = (np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float64)
             for v in pair)
    return h + lo


def _f32(x):
    return np.asarray(x, np.float32)


def test_two_sum_two_prod_exact():
    """s + e and p + e equal the float64 sum and product of the float32
    inputs exactly, over 40 binades, and equal the JAX package's bits."""
    rng = np.random.default_rng(0)
    a = _f32(rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096)))
    b = _f32(rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096)))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for t_fn, j_fn, exact in ((tdf.two_sum, jdf.two_sum, a64 + b64),
                              (tdf.two_prod, jdf.two_prod, a64 * b64)):
        hi, lo = t_fn(ta, tb)
        assert hi.dtype == lo.dtype == F32
        assert np.array_equal(_pair64((hi, lo)), exact)
        jh, jlo = j_fn(jnp.asarray(a), jnp.asarray(b))
        assert np.array_equal(hi.numpy(), np.asarray(jh))
        assert np.array_equal(lo.numpy(), np.asarray(jlo))


def _rand_matrix(rng, m, n):
    """Entries over 12 binades, half zero, one empty row."""
    A = rng.standard_normal((m, n)) * np.exp(rng.uniform(-6, 6, (m, n)))
    A[rng.random((m, n)) < 0.5] = 0.0
    A[5, :] = 0.0
    return A


def _operator(kind, A):
    """The float32 operator in both packages (the port's carried across)."""
    if kind == "dense":
        return jnp.asarray(_f32(A)), torch.as_tensor(_f32(A))
    if kind == "coo":
        jc = jl.coo_from_scipy(sp.csr_matrix(A), np.float32)
        return jc, convert.coo_from_dict(as_numpy_dict(jc), "cpu", F32)
    jb = jl.bde_from_scipy(sp.csr_matrix(A), 4, max_cmax=A.shape[1])
    jb = jb.__class__(**{f.name: (jnp.asarray(getattr(jb, f.name))
                                  if isinstance(getattr(jb, f.name), np.ndarray)
                                  else getattr(jb, f.name))
                         for f in dataclasses.fields(jb)})
    jb = dataclasses.replace(jb, vals=jb.vals.astype(jnp.float32),
                             vals_t=jb.vals_t.astype(jnp.float32))
    return jb, convert.bde_from_dict(as_numpy_dict(jb), "cpu", F32)


@pytest.mark.parametrize("kind", ["dense", "coo", "bde"])
def test_matvec2_and_rmatvec2_match(kind):
    rng = np.random.default_rng(1)
    A = _f32(_rand_matrix(rng, 36, 23)).astype(np.float64)
    jA, tA = _operator(kind, A)
    x = _f32(rng.standard_normal(23) * np.exp(rng.uniform(-4, 4, 23)))
    xl = _f32(x * 1e-8 * rng.standard_normal(23))
    y = _f32(rng.standard_normal(36))
    for t_fn, j_fn, vin, vlo, exact in (
            (tdf.matvec2, jdf.matvec2, x, xl, A @ (x.astype(np.float64) + xl)),
            (tdf.rmatvec2, jdf.rmatvec2, y, 0 * y, A.T @ y.astype(np.float64))):
        got = t_fn(tA, (torch.as_tensor(vin), torch.as_tensor(vlo)))
        ref = j_fn(jA, (jnp.asarray(vin), jnp.asarray(vlo)))
        assert _ulps(_pair64(got), _pair64(ref)) <= ULPS
        assert _ulps(_pair64(got), exact) <= ULPS


def test_kkt_rhs2_and_residual_pair_match():
    """The dense KKT pair operations and the refined dense solve, on a
    system whose rho_eq-weighted rows (1e3 rho) make kappa(M) ~ 1e5."""
    rng = np.random.default_rng(2)
    m, n = 30, 12
    A = _f32(_rand_matrix(rng, m, n) * 1e-3 + 0.1 * rng.standard_normal((m, n)))
    M = rng.standard_normal((n, n))
    P = _f32(M @ M.T / n * 1e-3)
    rho = _f32(np.abs(rng.normal(1.0, 0.3, m)) + 0.1)
    rho[:3] *= 1e3
    sigma = np.float32(1e-6)
    r1, r2 = _f32(rng.standard_normal(n)), _f32(rng.standard_normal(m))
    xh, xl = _f32(rng.standard_normal(n)), _f32(1e-8 * rng.standard_normal(n))
    T = {k: torch.as_tensor(v) for k, v in dict(A=A, P=P, rho=rho, r1=r1, r2=r2,
                                                 xh=xh, xl=xl).items()}
    T["sigma"] = torch.tensor(sigma)
    J = {k: jnp.asarray(v) for k, v in dict(A=A, P=P, rho=rho, r1=r1, r2=r2, xh=xh,
                                            xl=xl, sigma=sigma).items()}
    A64, P64, rho64 = (v.astype(np.float64) for v in (A, P, rho))
    M64 = P64 + float(sigma) * np.eye(n) + A64.T @ (rho64[:, None] * A64)
    t_exact = r1 + A64.T @ (rho64 * r2)
    t = tdf.kkt_rhs2(T["A"], T["rho"], T["r1"], T["r2"])
    assert _ulps(_pair64(t), _pair64(jdf.kkt_rhs2(J["A"], J["rho"], J["r1"], J["r2"]))) <= ULPS
    assert _ulps(_pair64(t), t_exact) <= ULPS
    res = tdf.kkt_residual_pair(T["P"], T["A"], T["sigma"], T["rho"], t, (T["xh"], T["xl"]))
    jres = jdf.kkt_residual_pair(J["P"], J["A"], J["sigma"], J["rho"],
                                 jdf.kkt_rhs2(J["A"], J["rho"], J["r1"], J["r2"]),
                                 (J["xh"], J["xl"]))
    exact = t_exact - M64 @ (xh.astype(np.float64) + xl)
    assert _ulps(res.numpy(), np.asarray(jres)) <= ULPS
    assert _ulps(res.numpy(), exact) <= ULPS
    # the refined dense solve: one step lands on the float64 solution
    st = tkkt.dense_factor(T["P"], T["A"], T["sigma"], T["rho"])
    x1, _ = tkkt.dense_solve(st, T["P"], T["A"], T["sigma"], T["rho"], T["r1"], T["r2"], 1)
    x0, _ = tkkt.dense_solve(st, T["P"], T["A"], T["sigma"], T["rho"], T["r1"], T["r2"], 0)
    x64 = np.linalg.solve(M64, t_exact)
    assert _ulps(x1.numpy(), x64) <= ULPS < _ulps(x0.numpy(), x64)


@pytest.fixture(scope="module")
def block():
    """The decomposed banded SDP's float32 operators and block-KKT state in
    both packages: the reference's meta carried across, a seeded rho."""
    info = jch.decompose(*jprob.banded_sdp(60, 5, seed=0, sparse=True)[:5],
                         ct.Settings())
    P, _, A, _, _ = info.problem
    P, A = sp.csr_matrix(P), sp.csr_matrix(A)
    m, n = A.shape
    jm = jbk.analyze(P, A, max_block=64)
    Pj, Aj = jl.coo_from_scipy(P, np.float32), jl.coo_from_scipy(A, np.float32)
    rng = np.random.default_rng(3)
    rho = _f32(np.abs(rng.normal(1.0, 0.3, m)) + 0.1)
    sigma = np.float32(1e-6)
    js = jbk.factor(jm, Pj, Aj, jnp.float32(sigma), jnp.asarray(rho), build_pair=True)
    tm = convert.blockkkt_meta_from_dict(as_numpy_dict(jm), "cpu")
    Pt = convert.coo_from_dict(as_numpy_dict(Pj), "cpu", F32)
    At = convert.coo_from_dict(as_numpy_dict(Aj), "cpu", F32)
    ts = tbk.factor(tm, Pt, At, torch.tensor(sigma), torch.as_tensor(rho), build_pair=True)
    A64, rho64 = A.toarray().astype(np.float32).astype(np.float64), rho.astype(np.float64)
    M64 = float(sigma) * np.eye(n) + A64.T @ (rho64[:, None] * A64)
    return dict(jm=jm, js=js, Pj=Pj, Aj=Aj, tm=tm, ts=ts, Pt=Pt, At=At, rho=rho,
                sigma=sigma, m=m, n=n, A64=A64, M64=M64, rng=rng)


def test_factor_pair_assembles_M_exactly(block):
    """factor(build_pair=True): Mh + Ml is M of the float32 data to double
    precision, as the JAX package's; Minv matches."""
    d = block
    for b, (jst, tst) in enumerate(zip(d["js"], d["ts"])):
        jb = d["jm"].buckets[b]
        cols = np.asarray(jb.cols)
        ext = np.zeros((d["n"] + 1, d["n"] + 1))
        ext[:d["n"], :d["n"]] = d["M64"]
        exact = ext[cols[:, :, None], cols[:, None, :]]
        exact[cols == d["n"]] = 0.0
        pad = cols == d["n"]
        exact[np.nonzero(pad)[0], np.nonzero(pad)[1], np.nonzero(pad)[1]] = 1.0
        got = _pair64((tst[1], tst[2]))
        assert _ulps(got, _pair64((jst[1], jst[2]))) <= ULPS
        assert np.abs(got - exact).max() <= 1e-12 * np.abs(exact).max()
        assert _ulps(tst[0].numpy(), np.asarray(jst[0])) <= 64


def test_refined_block_solves_match(block):
    """_solve_fused_refined, solve_blockspace(refine_steps=1) and the
    unfused refined solve: x to the JAX function and to the float64
    solution, nu to the JAX function."""
    d = block
    rng = np.random.default_rng(4)
    r1, r2 = _f32(rng.standard_normal(d["n"])), _f32(rng.standard_normal(d["m"]))
    rho, sigma = torch.as_tensor(d["rho"]), torch.tensor(d["sigma"])
    x64 = np.linalg.solve(d["M64"], r1 + d["A64"].T @ (d["rho"].astype(np.float64) * r2))
    jx, jnu = jbk._solve_fused_refined(d["jm"], d["js"], jnp.asarray(d["rho"]),
                                       jnp.asarray(r1), jnp.asarray(r2), 1)
    tx, tnu = tbk._solve_fused_refined(d["tm"], d["ts"], rho, torch.as_tensor(r1),
                                       torch.as_tensor(r2), 1)
    assert _ulps(tx.numpy(), np.asarray(jx)) <= ULPS
    assert _ulps(tx.numpy(), x64) <= ULPS
    assert _ulps(tnu.numpy(), np.asarray(jnu)) <= ULPS
    # block space: the same solution in the padded component layout
    cols = np.asarray(jbk.blockspace_cols(d["jm"]))
    r1g = np.concatenate([r1, [0.0]]).astype(np.float32)[cols]
    jxg, jnu2 = jbk.solve_blockspace(d["jm"], d["js"], jnp.asarray(d["rho"]),
                                     jnp.asarray(r1g), jnp.asarray(r2), 1)
    txg, tnu2 = tbk.solve_blockspace(d["tm"], d["ts"], rho, torch.as_tensor(r1g),
                                     torch.as_tensor(r2), 1)
    assert _ulps(txg.numpy(), np.asarray(jxg)) <= ULPS
    assert _ulps(txg.numpy(), np.concatenate([x64, [0.0]])[cols]) <= ULPS
    assert _ulps(tnu2.numpy(), np.asarray(jnu2)) <= ULPS
    # without the block-dense A the refinement runs the pair-matvec of
    # _matvec_pair and the compensated right-hand side of the global COO
    tm_coo = dataclasses.replace(d["tm"], buckets=tuple(
        dataclasses.replace(b, R=0, row_ids=None) for b in d["tm"].buckets))
    ts_coo = tuple((st[0], st[1], st[2], None, None) for st in d["ts"])
    tx3, _ = tbk.solve(tm_coo, ts_coo, d["Pt"], d["At"], sigma, rho,
                       torch.as_tensor(r1), torch.as_tensor(r2), 1)
    assert _ulps(tx3.numpy(), x64) <= ULPS
    mh, ml = tbk._matvec_pair(d["tm"], d["ts"], (torch.as_tensor(_f32(x64)),
                                                 torch.zeros(d["n"])))
    jmh, jml = jbk._matvec_pair(d["jm"], d["js"], (jnp.asarray(_f32(x64)),
                                                   jnp.zeros(d["n"], jnp.float32)))
    assert _ulps(_pair64((mh, ml)), _pair64((jmh, jml))) <= ULPS
    assert _ulps(_pair64((mh, ml)), d["M64"] @ _f32(x64)) <= ULPS
    th = tbk._block_rhs2(d["tm"], d["ts"], rho, torch.as_tensor(r1), torch.as_tensor(r2))
    jth = jbk._block_rhs2(d["jm"], d["js"], jnp.asarray(d["rho"]), jnp.asarray(r1),
                          jnp.asarray(r2))
    assert _ulps(_pair64(th), _pair64(jth)) <= ULPS


def test_compensated_residuals_match(block):
    """(rp, rd, mp, md) through the block-dense A, scaled, against the JAX
    function and a float64 evaluation."""
    d = block
    rng = np.random.default_rng(5)
    n, m = d["n"], d["m"]
    x, s, mu = (_f32(rng.standard_normal(k)) for k in (n, m, m))
    bv, q = _f32(rng.standard_normal(m)), _f32(rng.standard_normal(n))
    Einv, D = _f32(rng.uniform(0.5, 2.0, m)), _f32(rng.uniform(0.5, 2.0, n))
    cinv = np.float32(0.7)
    cols = np.asarray(jbk.blockspace_cols(d["jm"]))

    def g(v, pad=0.0):
        return np.concatenate([v, [pad]]).astype(np.float32)[cols]

    jout = jbk.compensated_residuals(
        d["jm"], d["js"], jnp.asarray(g(x)), jnp.asarray(s), jnp.asarray(mu),
        jnp.asarray(bv), jnp.asarray(g(q)), jnp.asarray(Einv), jnp.asarray(g(D)),
        jnp.asarray(cinv))
    tout = tbk.compensated_residuals(
        d["tm"], d["ts"], *(torch.as_tensor(v) for v in (g(x), s, mu, bv, g(q), Einv,
                                                          g(D))), torch.tensor(cinv))
    A64 = d["A64"]
    x64, q64, D64 = (v.astype(np.float64) for v in (x, q, D))
    Ax = A64 @ x64
    Atmu = A64.T @ mu.astype(np.float64)
    exact = (np.abs(Einv * (Ax + s - bv)).max(), cinv * np.abs(D64 * (q64 - Atmu)).max(),
             max(np.abs(Einv * Ax).max(), np.abs(Einv * s).max(), np.abs(Einv * bv).max()),
             cinv * max(np.abs(D64 * q64).max(), np.abs(D64 * Atmu).max()))
    for t, j, e in zip(tout, jout, exact):
        assert _ulps(t.numpy(), np.asarray(j)) <= ULPS
        assert _ulps(t.numpy(), e) <= ULPS


def test_coo_carries_segment_pointers():
    """coo_from_scipy carries the CSR/CSC segment pointers the compensated
    matvecs reduce with, equal to the JAX package's."""
    A = sp.random(9, 7, density=0.3, random_state=0, format="csr")
    jc, tc = jl.coo_from_scipy(A, np.float32), tl.coo_from_scipy(A, np.float32)
    for name in ("row_ptr", "col_ptr", "max_row_nnz", "max_col_nnz"):
        assert np.array_equal(np.asarray(getattr(jc, name)), getattr(tc, name)), name
