"""Tests of cosmo_tpu_torch that need a CUDA device. They skip without one.

This file imports neither JAX nor cosmo_tpu, so it runs on a machine that
has only PyTorch; run it there without the JAX conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import cosmo_tpu_torch as pt
from cosmo_tpu_torch import problems
from cosmo_tpu_torch.ops import jacobi_proj as J
from cosmo_tpu_torch.ops import jacobi_proj_rr as R


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stack(B, k, dtype, device, seed):
    G = np.random.default_rng(seed).standard_normal((B, k, k))
    return torch.as_tensor((G + G.swapaxes(1, 2)) / 2, dtype=dtype, device=device)


def _guard_stack(B, k, dtype, device, seed):
    """Symmetric Gaussian matrices; from B = 5 on, matrix 1 has equal
    diagonal entries (tau = 0), matrix 2 exact zeros off the diagonal (the
    identity rotation), matrix 3 one NaN entry and matrix 4 off-diagonal
    entries just above the identity guard (|tau| ~ 1e36, or 1e300 in f64:
    sqrt(1 + tau^2) rounds to |tau|)."""
    G = np.random.default_rng(seed).standard_normal((B, k, k))
    X = (G + G.swapaxes(1, 2)) / 2
    if B >= 5:
        X[1] = 0.25
        X[1][np.diag_indices(k)] = 1.0
        X[2] = np.diag(np.arange(k) % 3 - 1.0)
        X[3, 0, k - 1] = X[3, k - 1, 0] = np.nan
        X[4] = 1e-300 if dtype == torch.float64 else 1e-36
        X[4][np.diag_indices(k)] = np.arange(k) + 1.0
    return torch.as_tensor(X, dtype=dtype, device=device)


def _check_against_plain(wrapper, plain, dtype, tol, device):
    """Every even k of the kernels' domain (the register body up to 16, the
    shared-memory body above), B in {1, 31, 257}: one matrix a warp on an
    H100's 132 SMs. The register body packs several matrices a warp once
    B > 4 x 132; there B in {2498, 8539} also runs, where the guard
    matrices share a warp with live neighbours and the last warp is partly
    empty (k = 16: 4 a warp, 2 and 3 in the last). One counted launch
    each, a NaN matrix NaN and no other touched by it, the rest within
    ``tol`` of max |X|."""
    for k in range(4, 49, 2):
        for B in (1, 31, 257, 2498, 8539) if k <= 16 else (1, 31, 257):
            X = _guard_stack(B, k, dtype, device, seed=100 * k + B)
            before = wrapper.launches
            got = wrapper(X, 8)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            ref = plain(X, 8)
            bad = torch.isnan(X).flatten(1).any(1)
            assert torch.isnan(got[bad]).all()
            assert torch.isfinite(got[~bad]).all(), (k, B)
            err = (got[~bad] - ref[~bad]).abs().max().item()
            assert err <= tol * X[~bad].abs().max().item(), (k, B, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol):
    """The CUDA kernel against its plain version on the same inputs,
    relative to max |X|: f64 to 1e-10 (same angles, other rounding order);
    f32 to 1e-4, twice the ~2e-5 backward-error floor each of the two f32
    computations carries at k <= 48."""
    _check_against_plain(J.psd_project_pallas, J.psd_project_jacobi_plain, dtype, tol,
                         cuda)


@pytest.mark.cuda
def test_kernel_refuses_bad_input_on_card(cuda):
    X = _stack(4, 16, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        J.jacobi_proj_cuda(X.transpose(1, 2), 8)          # not contiguous
    with pytest.raises(ValueError):
        J.jacobi_proj_cuda(X.half(), 8)
    with pytest.raises(ValueError):
        J.jacobi_proj_cuda(_stack(4, 50, torch.float32, cuda, seed=0), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_rr_kernel_matches_plain_on_card(cuda, dtype, tol):
    """The slot-rotation CUDA kernel against its plain version, with the
    other kernel's limits (relative to max |X|)."""
    _check_against_plain(R.psd_project_rr, R.psd_project_jacobi_rr_plain, dtype, tol,
                         cuda)


@pytest.mark.cuda
def test_rr_kernel_refuses_bad_input_on_card(cuda):
    X = _stack(4, 16, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        R.jacobi_proj_rr_cuda(X.transpose(1, 2), 8)       # not contiguous
    with pytest.raises(ValueError):
        R.jacobi_proj_rr_cuda(X.half(), 8)
    with pytest.raises(ValueError):
        R.jacobi_proj_rr_cuda(_stack(4, 50, torch.float32, cuda, seed=0), 8)
    with pytest.raises(ValueError):
        R.jacobi_proj_rr_cuda(_stack(4, 15, torch.float32, cuda, seed=0), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("rr", [False, True], ids=["serial", "round_parallel"])
def test_decomposed_solve_on_card(cuda, monkeypatch, rr):
    """A small decomposed banded SDP through the block-diagonal KKT on the
    card in float64: Solved, and every projection launched the kernel the
    gate selects."""
    if rr:
        monkeypatch.setenv("COSMO_TPU_PALLAS_RR", "1")
    J.psd_project_pallas.launches = R.psd_project_rr.launches = 0
    model = pt.Model(pt.Settings(decompose=True, accelerator=None, dtype=np.float64,
                                 eigh_backend="pallas"))
    res = model.set(*problems.banded_sdp(200, 8, seed=0, sparse=True)[:5]).optimize()
    assert res.status == "Solved"
    assert model.last_solve["kkt_solver"] == "blockdiag"
    launches = (J.psd_project_pallas.launches, R.psd_project_rr.launches)
    n = model.last_solve["projections"]
    assert launches == ((0, n) if rr else (n, 0))


@pytest.mark.cuda
def test_df32_error_free_transforms_exact_on_card(cuda):
    """two_sum and two_prod stay error-free on the card (each op its own
    kernel, no fused multiply-add): s + e and p + e equal the float64 sum
    and product of the float32 inputs exactly."""
    from cosmo_tpu_torch.ops import df32

    rng = np.random.default_rng(0)
    a64 = rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
    b64 = rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
    a = torch.as_tensor(a64, dtype=torch.float32, device=cuda)
    b = torch.as_tensor(b64, dtype=torch.float32, device=cuda)
    af, bf = a.double(), b.double()
    s, e = df32.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), af + bf)
    p, e = df32.two_prod(a, b)
    assert torch.equal(p.double() + e.double(), af * bf)


@pytest.mark.cuda
def test_anderson_step_never_waits_for_the_card(cuda):
    """One Anderson step (history update, candidate, rank test) on the card
    under torch.cuda.set_sync_debug_mode("error"), which raises on any
    synchronizing call, gives the CPU's result."""
    from cosmo_tpu_torch import accel

    d, mem = 2000, 15
    xs_np = np.random.default_rng(1).standard_normal((6, d))
    outs = []
    for device in ("cpu", cuda):
        aa = accel.init_accel(d, mem, torch.float64, device)
        aa.active = torch.ones((), dtype=torch.bool, device=device)
        xs = torch.as_tensor(xs_np, device=device)
        gate = torch.ones((), dtype=torch.bool, device=device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(5):
                g = 0.5 * xs[t] + 0.1 * xs[t + 1]
                aa = accel.update(aa, g, xs[t], gate=gate)
                w, aa = accel.accelerate(aa, g, gate=gate)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append((w.cpu(), bool(aa.success), int(aa.count)))
    (w0, ok0, n0), (w1, ok1, n1) = outs
    assert ok0 and ok1 and n0 == n1 == 4
    assert torch.allclose(w0, w1, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_default_settings_decomposed_float32_on_card(cuda):
    """A small decomposed banded SDP at the default settings in float32 on
    the card: Anderson, the refine latch and the df32 block KKT through the
    Jacobi kernel; Solved, the latch tripped, every projection launched
    the kernel."""
    J.psd_project_pallas.launches = 0
    model = pt.Model(pt.Settings(decompose=True, eigh_backend="pallas"))
    res = model.set(*problems.banded_sdp(200, 8, seed=0, sparse=True)[:5]).optimize()
    info = model.last_solve
    assert res.status == "Solved"
    assert info["dtype"] == torch.float32 and info["kkt_refine_steps"] == 1
    assert info["refine_iter"] > 0 and info["n_accelerated"] > 0
    assert res.info.res_history[-1, 5] == 1.0
    assert J.psd_project_pallas.launches == info["projections"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("side,colpad", [(96, False), (90, False), (192, False),
                                         (64, True), (896, True)],
                         ids=["shear96", "shear90_padded", "shear192", "colpad64",
                              "colpad896"])
def test_large_side_layouts_on_card(cuda, side, colpad):
    """The shear and colpad gathers and scatters on the card equal the
    CPU's in float32 (to 1e-6 relative), the colpad pad slots exactly 0.
    Two blocks a bucket; the scatter writes into a zero vector."""
    from cosmo_tpu_torch.models import cones as C
    from cosmo_tpu_torch.ops import conedata, projections

    cone = (C.PsdConeTriangleColPad(side * side) if colpad
            else C.PsdConeTriangle(side * (side + 1) // 2))
    host = conedata.compile_cones([cone, type(cone)(cone.dim)], dtype=np.float32,
                                  device="cpu")
    assert host.psd_buckets[0].fastpath == ("colpad" if colpad else "shear")
    v = np.random.default_rng(side).standard_normal(host.m)
    outs = []
    for device in ("cpu", cuda):
        cones = conedata.to_device(host, device, torch.float32)
        bucket = cones.psd_buckets[0]
        w = torch.as_tensor(v, dtype=torch.float32, device=device)
        X = projections._psd_gather(projections._ext(w), bucket)
        s = projections._psd_scatter(torch.zeros_like(w), X, bucket)
        outs.append((X.cpu(), s.cpu()))
    (X0, s0), (X1, s1) = outs
    for a, b in ((X0, X1), (s0, s1)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6 * a.abs().max().item())
    if colpad:
        pad = torch.ones(side, side, dtype=torch.bool).tril(-1).T.reshape(-1)
        assert (s1.reshape(2, -1)[:, pad] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_graph_replays_the_eager_steps_on_card(cuda, dtype):
    """kkt.CGGraph runs the masked CG blocks as CUDA graph replays: the same
    steps as the eager blocks — in f64 the same step count and x within
    1e-12 relative; in f32 the count within one step and x within 1e-4
    (cuSPARSE's CSR product may round in another order from run to run,
    and an f32 residual can sit at the target) — with and without the
    overlap preconditioner and the compensated restart, and a reused graph
    gives the same answer on another right-hand side."""
    from cosmo_tpu_torch import chordal
    from cosmo_tpu_torch.ops import kkt as kkt_ops
    from cosmo_tpu_torch.ops import linops

    P, q, A, b, sets, _ = problems.banded_sdp(60, 4, seed=0, sparse=True)
    info = chordal.decompose(P, q, A, b, sets, pt.Settings(decompose=True))
    Pd, _, Ad, _, _ = info.problem
    Pc, Ac = (linops.coo_to_device(linops.coo_from_scipy(M), cuda, dtype) for M in (Pd, Ad))
    m, n = Ad.shape
    rng = np.random.default_rng(0)
    T = lambda v: torch.as_tensor(v, dtype=dtype, device=cuda)  # noqa: E731
    rho, x0 = T(rng.random(m) + 0.5), T(0.1 * rng.standard_normal(n))
    f64 = dtype == torch.float64
    tol = 1e-12 if f64 else 1e-4
    for precond in (None, kkt_ops.make_overlap_precond(
            info.n_orig, info.ov_child_rows, info.ov_parent_rows, cuda)):
        graph = kkt_ops.CGGraph()
        for refine, seed in ((0, 1), (1, 2), (0, 3)):
            r1 = T(np.random.default_rng(seed).standard_normal(n))
            r2 = T(np.random.default_rng(seed + 10).standard_normal(m))
            args = (Pc, Ac, T(1e-6), rho, r1, r2, x0, T(1e-9), T(np.inf), 200, refine)
            xe, _, ke, reads_e = kkt_ops.cg_solve(*args, precond=precond, block=3)
            xg, _, kg, reads_g = kkt_ops.cg_solve(*args, precond=precond, block=3,
                                                   graph=graph)
            assert int(ke) > 0 and abs(int(kg) - int(ke)) <= (0 if f64 else 1)
            assert reads_g == reads_e or not f64
            assert (xg - xe).abs().max().item() <= tol * xe.abs().max().item()


@pytest.mark.cuda
def test_coo_products_on_card_are_segment_sums(cuda):
    """On the card a Coo's products, diagonal and column sums are the
    CPU's sums within 1e-12 in f64, with a long row (the portfolio's factor
    rows) and empty rows and columns; the copy that reaches
    SEGMENT_REDUCE_WIDTH (the rows, by torch.segment_reduce, no atomics)
    gives the same bits on a second run."""
    import scipy.sparse as sp
    from cosmo_tpu_torch.ops import linops

    rng = np.random.default_rng(0)
    width = linops.SEGMENT_REDUCE_WIDTH + 72
    A = sp.random(300, width, density=0.05, random_state=1, format="lil")
    A[7, :] = rng.standard_normal(width)               # a long row
    A[9, :] = 0.0
    A[:, 11] = 0.0
    A = sp.csr_matrix(A)
    P = sp.csr_matrix(sp.random(200, 200, density=0.05, random_state=2) + sp.eye(200))
    x, y, rho = rng.standard_normal(width), rng.standard_normal(300), rng.random(300) + 0.5
    host, card = [], []
    for device, out in (("cpu", host), (cuda, card), (cuda, card)):
        Ac, Pc = (linops.coo_to_device(linops.coo_from_scipy(M), device, torch.float64)
                  for M in (A, P))
        T = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
        out.append([linops.matvec(Ac, T(x)), linops.rmatvec(Ac, T(y)),
                    linops.diag_part(Pc), linops.diag_AtRhoA(Ac, T(rho))])
    assert Ac.max_row_nnz >= linops.SEGMENT_REDUCE_WIDTH
    assert torch.equal(card[0][0], card[1][0])
    for h, c in zip(host[0], card[0]):
        assert (c.cpu() - h).abs().max().item() <= 1e-12 * max(1.0, h.abs().max().item())


def _cone_points(n, dtype, device, seed):
    """Rows covering the four cases of the exp and pow projections (a
    Gaussian times a scale from e^-3 to e^3, every 20th row with |z| =
    1e-9), half of them dual cones, tolerances 1e-8 and 1e-6."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-3, 3, (n, 1)))
    V[::20, 2] = 1e-9 * np.sign(V[::20, 2])
    to = dict(dtype=dtype, device=device)
    return (torch.as_tensor(V, **to), torch.as_tensor(rng.random(n) < 0.5, device=device),
            torch.as_tensor(np.where(rng.random(n) < 0.5, 1e-8, 1e-6), **to))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_exp_pow_kernel_matches_plain_on_card(cuda, dtype):
    """The exp/pow kernel against its plain version on the same rows, one
    counted launch a call, relative to max |V|: float64 to 1e-10 (the
    same operations; CUDA's log, exp and pow differ from the CPU's in the
    last bits); float32 exp to 1e-4, float32 pow to 1e-4 on all but 1 row
    in 1,000 (where the reference's float32 Newton keeps no digit)."""
    from cosmo_tpu_torch.ops import exp_pow as E
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    for n in (1, 1000, 65122):
        V, dual, tol = _cone_points(n, dtype, cuda, seed=n)
        scale = V.abs().max().item()
        before = K.project_exp.launches
        got = K.project_exp(V, dual, tol, 100)
        torch.cuda.synchronize()
        assert K.project_exp.launches == before + 1
        err = (got - E.project_exp_plain(V, dual, tol, 100)).abs().max().item()
        assert err <= (1e-10 if dtype == torch.float64 else 1e-4) * scale, (n, err)
        for a in (0.3, 0.5, 0.8):
            alpha = torch.full((n,), a, dtype=dtype, device=cuda)
            got = K.project_pow(V, alpha, dual, tol, 20)
            row = (got - E.project_pow_plain(V, alpha, dual, tol, 20)).abs().amax(1) / scale
            if dtype == torch.float64:
                assert row.max().item() <= 1e-10, (n, a)
            else:
                assert (row > 1e-4).sum().item() <= max(1, n // 1000), (n, a)


@pytest.mark.cuda
def test_exp_pow_kernel_refuses_bad_input_on_card(cuda):
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    V, dual, tol = _cone_points(8, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        K.exp_proj_cuda(V.half(), dual, tol, 100)
    with pytest.raises(ValueError):
        K.exp_proj_cuda(V[:, :2], dual, tol, 100)
    with pytest.raises(ValueError):
        K.pow_proj_cuda(V, tol[:4], dual, tol, 20)


@pytest.mark.cuda
def test_logistic_regression_on_card(cuda):
    """An a9a-shaped logistic regression (2,000 samples) in float64 on the
    card: Solved, every projection of the 4,000 exp cones one kernel
    launch, the weights' loss within 1e-6 of the optimum."""
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    P, q, A, b, sets, (Z, y) = problems.logistic_regression(2000, 123, 14, lam=0.5, seed=0)
    model = pt.Model(pt.Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64))
    K.project_exp.launches = 0
    res = model.set(P, q, A, b, sets).optimize()
    assert res.status == "Solved"
    assert K.project_exp.launches == model.last_solve["projections"] > 0
    f_opt, _ = problems.logistic_optimum(Z, y, 0.5)
    loss, _ = problems.logistic_loss(Z, y, 0.5, res.x[:123])
    assert abs(loss - f_opt) <= 1e-6 * f_opt


@pytest.mark.cuda
def test_loose_phase_products_on_card(cuda):
    """On the card the loose phase's three TF32 passes keep the polar
    projection of 256 x 256 blocks within 1e-5 of max |X| of the float32
    one, where a single TF32 pass is an order of magnitude further off."""
    from cosmo_tpu_torch.ops import eigh as E

    X = _stack(8, 256, torch.float32, cuda, seed=0)
    ref = E.psd_project_polar(X.double()).float()
    three = (E.psd_project_polar(X, tf32=True) - ref).abs().max().item()
    with E.tf32_matmuls():
        one = (E._polar(X, 9, 6, torch.matmul) - ref).abs().max().item()
    scale = X.abs().max().item()
    assert three <= 1e-5 * scale and one >= 10 * three, (three, one)
