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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_kernel_matches_plain_on_card(cuda, dtype, tol):
    """The CUDA kernel against its plain version on the same inputs,
    relative to max |X|: f64 to 1e-10 (same angles, other rounding order);
    f32 to 1e-4, twice the ~2e-5 backward-error floor each of the two f32
    computations carries at k <= 48."""
    for k in (8, 16, 32, 48):
        X = _stack(257, k, dtype, cuda, seed=k)
        before = J.psd_project_pallas.launches
        got = J.psd_project_pallas(X, 8)
        torch.cuda.synchronize()
        assert J.psd_project_pallas.launches == before + 1
        ref = J.psd_project_jacobi_plain(X, 8)
        assert (got - ref).abs().max().item() <= tol * X.abs().max().item()


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
    """The round-parallel CUDA kernel against its plain version, with the
    serial kernel's limits (relative to max |X|)."""
    for k in (8, 16, 32, 48):
        X = _stack(257, k, dtype, cuda, seed=k)
        before = R.psd_project_rr.launches
        got = R.psd_project_rr(X, 8)
        torch.cuda.synchronize()
        assert R.psd_project_rr.launches == before + 1
        ref = R.psd_project_jacobi_rr_plain(X, 8)
        assert (got - ref).abs().max().item() <= tol * X.abs().max().item()


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
