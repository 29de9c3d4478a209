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
from cosmo_tpu_torch.ops import eigh
from cosmo_tpu_torch.ops import jacobi_eig as JE
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ruiz_graph_replays_the_eager_scaling_on_card(cuda, dtype):
    """ops/scaling.RuizGraph gives the eager equilibration's bits on three
    right-hand sides of one dense problem with a second-order cone (the
    rectified segments), capturing at the first; a Model keeps one graph
    across update() re-solves, captured once, and lands on the CPU's
    objective within 1e-6 relative (f64)."""
    from cosmo_tpu_torch.ops import scaling as scaling_ops
    from cosmo_tpu_torch.settings import split_settings

    rng = np.random.default_rng(0)
    n = 8
    M = rng.standard_normal((n, n))
    P, q = M @ M.T / n + np.eye(n), rng.standard_normal(n)
    cons = [pt.Constraint(np.eye(n), np.zeros(n), pt.Nonnegatives),
            pt.Constraint(np.vstack([np.zeros((1, n)), np.eye(n)[:4]]),
                          np.r_[1.0, np.zeros(4)], pt.SecondOrderCone)]
    s = pt.Settings(dtype=np.float64 if dtype == torch.float64 else np.float32)
    model = pt.Model(s)
    model.assemble(P, q, cons)
    model.optimize()
    dev = model._dev_cache
    m = dev["bd"].shape[0]
    static, dyn = split_settings(model._resolved_settings, m, n, dtype, device=cuda)
    graph = scaling_ops.RuizGraph()
    flat = lambda out: [*out[:6], *out[6]]  # noqa: E731
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        qd = torch.as_tensor(r.standard_normal(n) * 10.0 ** r.integers(-3, 3), dtype=dtype,
                             device=cuda)
        bd = torch.as_tensor(r.standard_normal(m), dtype=dtype, device=cuda)
        args = (dev["Pd"], dev["Ad"], qd, bd, dev["cones"], static.scaling_iters, dyn)
        eager = [t.clone() for t in flat(scaling_ops.ruiz_scale(*args))]
        replayed = flat(scaling_ops.ruiz_scale(*args, graph=graph))
        assert all(torch.equal(e, g) for e, g in zip(eager, replayed))
    captured = dev["scale_graph"].graph
    for scale in (2.0, 0.5):
        res = model.update(q=q * scale).optimize()
        assert dev["scale_graph"].graph is captured
        if dtype == torch.float64:
            ref = pt.Model(s, device="cpu").assemble(P, q * scale, cons).optimize()
            assert res.status == ref.status == "Solved"
            assert abs(res.obj_val - ref.obj_val) <= 1e-6 * max(1.0, abs(ref.obj_val))


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
    in 1,000 (where the reference's float32 Newton keeps no digit). On the
    card both take CUDA's log and exp: every exp row has the plain
    version's bits."""
    from cosmo_tpu_torch.ops import exp_pow as E
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    for n in (1, 1000, 65122):
        V, dual, tol = _cone_points(n, dtype, cuda, seed=n)
        scale = V.abs().max().item()
        before = K.project_exp.launches
        got = K.project_exp(V, dual, tol, 100)
        torch.cuda.synchronize()
        assert K.project_exp.launches == before + 1
        ref = E.project_exp_plain(V, dual, tol, 100)
        err = (got - ref).abs().max().item()
        assert err <= (1e-10 if dtype == torch.float64 else 1e-4) * scale, (n, err)
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        differ = (got.view(bits) != ref.view(bits)).any(dim=1).sum().item()
        assert differ == 0, (n, differ)
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
def test_pow_kernel_on_recorded_pnorm_stacks(cuda):
    """An l1.5 regression in a9a's shape (2,000 samples, a power cone
    each) in float64 on the card: Solved, every
    projection one pow launch, ||Z w - y||_p within 1e-6 of the L-BFGS-B
    optimum; on its first, middle and last recorded stacks the kernel
    gives the plain version's bits."""
    from cosmo_tpu_torch import profile_exp as PE
    from cosmo_tpu_torch.ops import exp_pow as E
    from cosmo_tpu_torch.ops import exp_pow_proj as K

    P, q, A, b, sets, (Z, y) = problems.pnorm_regression(2000, 123, 14, 1.5, seed=0)
    model = pt.Model(pt.Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64))
    K.project_pow.launches = 0
    with PE.recorded_stacks("pow") as stacks:
        res = model.set(P, q, A, b, sets).optimize()
    assert res.status == "Solved"
    assert K.project_pow.launches == model.last_solve["projections"] == stacks["n"] > 0
    f_opt, _ = problems.pnorm_optimum(Z, y, 1.5)
    assert abs(problems.pnorm_loss(Z, y, 1.5, res.x[:123]) - f_opt) <= 1e-6 * f_opt
    args = (stacks["alpha"], stacks["is_dual"], stacks["tol"], stacks["max_iter"])
    for k in (0, stacks["n"] // 2, stacks["n"] - 1):
        V = PE.recorded_stack(stacks, k)
        got = K.pow_proj_cuda(V, *args)
        assert PE.differing_rows(got, E.project_pow_plain(V, *args)) == 0, k


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


def _eig_case(B, k, warm, dtype, device, seed):
    """(X, W, V0) of one amortized projection: X symmetric Gaussian; warm,
    V0 its eigenbasis turned by an orthogonal matrix near I (angles ~0.01,
    ~0.01 sqrt(48 / k) above k = 48: under the staleness rule) and W = V0'
    X V0; stale, V0 = I and W = X."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, k, k))
    X = (G + G.swapaxes(1, 2)) / 2
    if warm:
        R = rng.standard_normal((B, k, k)) * 0.01 * min(1.0, np.sqrt(48 / k))
        R, _ = np.linalg.qr(np.eye(k) + (R - R.swapaxes(1, 2)))
        V0 = np.linalg.eigh(X)[1] @ R
        W = V0.swapaxes(1, 2) @ X @ V0
        W = (W + W.swapaxes(1, 2)) / 2
    else:
        V0, W = np.broadcast_to(np.eye(k), (B, k, k)), X
    return tuple(torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
                 for a in (X, W, V0))


def _eig_diff(X, got, ref):
    """max |P - P_ref|, max |V - V_ref| and the largest difference of V
    diag(V'XV) V' between the two (unchanged by rotations among the
    eigenvectors of nearly equal eigenvalues, which rounding does not
    determine in float32)."""
    def rec(V):
        d = torch.diagonal(V.transpose(1, 2) @ X @ V, dim1=1, dim2=2)
        return V @ (d[:, :, None] * V.transpose(1, 2))

    return ((got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item(),
            (rec(got[1]) - rec(ref[1])).abs().max().item())


def _fused_against_plain(X, V0, dtype, tol, n_full=None):
    """jacobi_eig on (X, V0) against eigh.psd_project_amortized: P and V
    diag(V'XV) V' within ``tol`` of max |X|, V itself in float64, the
    kernel's flag the plain rule's. Returns the rule's flag."""
    P, V, stale = JE.jacobi_eig_cuda(X, V0, 2, 8, n_full)
    torch.cuda.synchronize()
    ref = eigh.psd_project_amortized(X, V0, 2, 8)
    rule = bool(eigh.amortized_rotate(X, V0)[2])
    dP, dV, dR = _eig_diff(X, (P, V), ref)
    scale = X.abs().max().item()
    assert bool(stale) == rule
    assert dP <= tol * scale and dR <= tol * scale, (dP, dR)
    if dtype == torch.float64:
        assert dV <= tol * scale, dV
    return rule


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_jacobi_eig_kernel_matches_plain_on_card(cuda, dtype, tol):
    """The amortized projection's kernel (the rotation, the staleness test
    and the sweeps in one launch) on (X, V_prev) against its plain version,
    every even k of its domain, B in {1, 31, 2498} (k <= 16) or {1, 31},
    warm (2 sweeps) and stale (8 sweeps, from I), as the staleness rule
    classes them: the kernel's flag the rule's, one full-sweep tally a
    stale launch; P and V diag(V'XV) V' within ``tol`` of max |X|, and in
    float64 V itself."""
    n_full = torch.zeros(1, dtype=torch.int32, device=cuda)
    n_stale = 0
    for k in range(4, 49, 2):
        for B in (1, 31, 2498) if k <= 16 else (1, 31):
            for warm in (True, False):
                X, _, V0 = _eig_case(B, k, warm, dtype, cuda, seed=100 * k + B)
                rule = _fused_against_plain(X, V0, dtype, tol, n_full)
                assert rule != warm, (k, B, warm)
                n_stale += rule
    assert n_full.item() == n_stale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_jacobi_eig_one_stale_block_and_past_one_wave_on_card(cuda, dtype, tol):
    """One stale block among 2,497 warm ones sets the kernel's flag and sends
    every block to the full sweeps (the plain version's P and V), counted
    once by the tally; stacks past one wave of the persistent grid
    (``jacobi_eig.eig_wave``; the warps store their earlier groups' W and V
    across the grid barrier) at k = 8 (register body) and 32 (shared-memory
    body), warm and stale, match the plain version."""
    n_full = torch.zeros(1, dtype=torch.int32, device=cuda)
    X, _, V0 = _eig_case(2498, 16, True, dtype, cuda, seed=3)
    V0[1000] = torch.eye(16, dtype=dtype, device=cuda)
    assert _fused_against_plain(X, V0, dtype, tol, n_full)
    assert n_full.item() == 1
    for k in (8, 32):
        B = JE.eig_wave(k, dtype, cuda.index or 0) * 3 // 2 + 1
        for warm in (True, False):
            X, _, V0 = _eig_case(B, k, warm, dtype, cuda, seed=k + warm)
            assert _fused_against_plain(X, V0, dtype, tol) != warm


@pytest.mark.cuda
def test_jacobi_eig_refuses_bad_input_on_card(cuda):
    X, _, V0 = _eig_case(4, 16, True, torch.float32, cuda, seed=0)
    for args in ((X.transpose(1, 2), V0), (X, V0.transpose(1, 2)), (X.half(), V0.half()),
                 (X, V0.double()), (X[:, :15, :15].contiguous(), V0[:, :15, :15].contiguous()),
                 (X.cpu(), V0.cpu())):
        with pytest.raises(ValueError):
            JE.jacobi_eig_cuda(*args, 2, 8)
    X49, _, V49 = _eig_case(2, 49, False, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        JE.jacobi_eig_cuda(X49, V49, 2, 8)
    _, W16, V16 = _eig_case(2, 16, False, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        JE.jacobi_eig_large_cuda(W16, V16, torch.tensor(False, device=cuda), 2, 8)
    X50, _, V50 = _eig_case(2, 50, False, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError):
        JE.jacobi_eig_cuda(X50, V50, 2, 8)
    with pytest.raises(ValueError):
        JE.jacobi_eig_cuda(X, V0, 2, 8, torch.zeros(1, dtype=torch.int64, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_jacobi_eig_large_kernel_matches_plain_on_card(cuda, dtype, tol):
    """The large-side kernel (jacobi_eig_large) against its plain version
    through its launcher, k in {2, 50, 64, 258}, B in {1, 3}, warm (2
    sweeps) and stale (8 sweeps, from I) as the staleness rule classes
    them: one full-sweep tally a stale launch; P and V diag(V'XV) V' within
    ``tol`` of max |X|, and in float64 V itself; 0 sweeps give V0 and the
    reconstruction from diag W."""
    n_full = torch.zeros(1, dtype=torch.int32, device=cuda)
    n_stale = 0
    for k in (2, 50, 64, 258):
        for B in (1, 3):
            for warm in (True, False):
                X, W, V0 = _eig_case(B, k, warm, dtype, cuda, seed=100 * k + B)
                stale = eigh.amortized_rotate(X, V0)[2]
                assert bool(stale) != warm, (k, B, warm)
                n_stale += not warm
                got = JE.jacobi_eig_large_cuda(W, V0, stale, 2, 8, n_full)
                torch.cuda.synchronize()
                ref = JE.jacobi_eig_plain(W, V0, stale, 2, 8)
                dP, dV, dR = _eig_diff(X, got, ref)
                scale = X.abs().max().item()
                assert dP <= tol * scale and dR <= tol * scale, (k, B, warm, dP, dR)
                if dtype == torch.float64:
                    assert dV <= tol * scale, (k, B, warm, dV)
    assert n_full.item() == n_stale
    _, W, V0 = _eig_case(2, 50, True, dtype, cuda, seed=1)
    P, V = JE.jacobi_eig_large_cuda(W, V0, torch.tensor(False, device=cuda), 0, 0)
    assert torch.equal(V, V0)
    assert torch.equal(P, eigh.sym_reconstruct(torch.diagonal(W, dim1=1, dim2=2), V0))


@pytest.mark.cuda
def test_amortized_solve_with_a_large_side_on_card(cuda):
    """block_sdp(1, 56, 12) with the amortized backend and psd_pad_to=1 (one
    [1, 56] bucket) on the card in float64, against the same solve on the
    CPU (objective within 1e-6 relative); jacobi_eig_cluster (kernel_for's
    kernel at side 56) launched once a projection, no other Jacobi
    kernel."""
    P, q, A, b, sets = problems.block_sdp(n_blocks=1, side=56, n=12, seed=5)
    s = pt.Settings(eps_abs=1e-5, eps_rel=1e-5, eigh_backend="amortized", psd_pad_to=1,
                    dtype=np.float64)
    JE.reset_counts()
    model = pt.Model(s)
    res = model.set(P, q, A, b, sets).optimize()
    assert JE.kernel_for(56, torch.float64) == "jacobi_eig_cluster"
    assert JE.launches_of("jacobi_eig_cluster") == model.last_solve["projections"] > 0
    assert JE.launches_of("jacobi_eig") == JE.launches_of("jacobi_eig_large") == 0
    full = JE.full_sweep_counts(cuda)
    assert full[("jacobi_eig_cluster", 56, "float64")] <= model.last_solve["projections"]
    assert sum(full.values()) == full[("jacobi_eig_cluster", 56, "float64")]
    ref = pt.Model(s, device="cpu").set(P, q, A, b, sets).optimize()
    assert res.status == ref.status == "Solved"
    assert abs(res.obj_val - ref.obj_val) <= 1e-6 * abs(ref.obj_val)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_jacobi_eig_cluster_kernel_matches_plain_on_card(cuda, dtype):
    """The cluster kernel (jacobi_eig_cluster) against its plain version
    through its launcher, k in {2, 50, 64, 130, 258}, B in {1, 3}, warm (2
    sweeps) and stale (8 sweeps, from I) as the staleness rule classes
    them, at every cluster size whose CTAs hold W (up to 16 the card
    schedules): the plain version's bits in P and V, one full-sweep tally a
    stale launch; 0 sweeps give V0 and the reconstruction from diag W."""
    n_full = torch.zeros(1, dtype=torch.int32, device=cuda)
    n_stale = 0
    for k in (2, 50, 64, 130, 258):
        for B in (1, 3):
            for warm in (True, False):
                X, W, V0 = _eig_case(B, k, warm, dtype, cuda, seed=100 * k + B)
                stale = eigh.amortized_rotate(X, V0)[2]
                assert bool(stale) != warm, (k, B, warm)
                ref = JE.jacobi_eig_plain(W, V0, stale, 2, 8)
                for C in JE._cluster_sizes(k, dtype.itemsize):
                    n_stale += not warm
                    got = JE.jacobi_eig_cluster_cuda(W, V0, stale, 2, 8, n_full, cluster=C)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                        k, B, warm, C, _eig_diff(X, got, ref))
    assert n_full.item() == n_stale
    _, W, V0 = _eig_case(2, 50, True, dtype, cuda, seed=1)
    P, V = JE.jacobi_eig_cluster_cuda(W, V0, torch.tensor(False, device=cuda), 0, 0)
    assert torch.equal(V, V0)
    assert torch.equal(P, eigh.sym_reconstruct(torch.diagonal(W, dim1=1, dim2=2), V0))


@pytest.mark.cuda
def test_jacobi_eig_cluster_refuses_bad_input_on_card(cuda):
    """The cluster launcher refuses a side past its bytes (float64 610, the
    large kernel's), a side of the small kernel and a cluster size the
    kernel does not launch (a build or launch error raises)."""
    stale = torch.tensor(False, device=cuda)
    for k in (610, 16):
        _, W, V0 = _eig_case(1, k, False, torch.float64, cuda, seed=0)
        with pytest.raises(ValueError):
            JE.jacobi_eig_cluster_cuda(W, V0, stale, 2, 8)
    _, W, V0 = _eig_case(1, 50, False, torch.float64, cuda, seed=0)
    for C in (3, 32):
        with pytest.raises(RuntimeError, match="CUDA error"):
            JE.jacobi_eig_cluster_cuda(W, V0, stale, 2, 8, cluster=C)


@pytest.mark.cuda
def test_amortized_solve_through_the_cluster_kernel_on_card(cuda):
    """block_sdp(3, 64, 24) in float64 with the amortized backend and
    psd_pad_to=1 (one [3, 64] bucket) on the card against the same solve on
    the CPU (objective within 1e-6 relative): jacobi_eig_cluster launched
    once a projection, its tally keyed (kernel, k, dtype)."""
    P, q, A, b, sets = problems.block_sdp(n_blocks=3, side=64, n=24, seed=7)
    s = pt.Settings(eps_abs=1e-6, eps_rel=1e-6, eigh_backend="amortized", psd_pad_to=1,
                    dtype=np.float64)
    JE.reset_counts()
    model = pt.Model(s)
    res = model.set(P, q, A, b, sets).optimize()
    launches = dict(JE.psd_project_amortized.launches)
    assert launches == {("jacobi_eig_cluster", 64, "float64"):
                        model.last_solve["projections"]}
    assert set(JE.full_sweep_counts(cuda)) >= set(launches)
    ref = pt.Model(s, device="cpu").set(P, q, A, b, sets).optimize()
    assert res.status == ref.status == "Solved"
    assert abs(res.obj_val - ref.obj_val) <= 1e-6 * abs(ref.obj_val)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["amortized", "jacobi_mm"])
def test_eigh_backends_solve_on_card(cuda, backend):
    """block_sdp(12, 8, 48) with the amortized and the jacobi_mm backend on
    the card in float64, against the same solve on the CPU (objective
    within 1e-6 relative); the amortized one launches the kernel once a
    projection."""
    P, q, A, b, sets = problems.block_sdp(n_blocks=12, side=8, n=48, seed=5)
    s = pt.Settings(eps_abs=1e-7, eps_rel=1e-7, eigh_backend=backend, jacobi_sweeps=10,
                    dtype=np.float64)
    JE.reset_counts()
    model = pt.Model(s)
    res = model.set(P, q, A, b, sets).optimize()
    ref = pt.Model(s, device="cpu").set(P, q, A, b, sets).optimize()
    assert res.status == ref.status == "Solved"
    assert abs(res.obj_val - ref.obj_val) <= 1e-6 * abs(ref.obj_val)
    launches = sum(JE.psd_project_amortized.launches.values())
    assert launches == (model.last_solve["projections"] if backend == "amortized" else 0)
