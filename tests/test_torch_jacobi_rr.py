"""The round-parallel Jacobi PSD projection of cosmo_tpu_torch
(ops/jacobi_proj_rr.py) against the JAX package's TPU kernel
``pallas_eigh._proj_kernel_rr``, run in Pallas interpret mode on the CPU
(as tests/test_eigh.py runs it).

On the CPU the wrappers run the kernel's plain PyTorch version; the CUDA
kernel itself is held to that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import pallas_eigh
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.ops import jacobi_proj as J
from cosmo_tpu_torch.ops import jacobi_proj_rr as R

from _torch_port import eigh_projection, sym_stack

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [4, 8, 16, 24, 32, 40, 48])
def test_pair_table_follows_reference_slot_rotation(k):
    """Round r of the table holds the original indices that the reference's
    ``_slot_rotate``, applied r times, puts at slots (2t, 2t+1); after k - 1
    rotations the layout is the identity again."""
    labels = jnp.arange(k)
    table = R.pair_table(k)
    assert table.shape == (k - 1, k // 2, 2) and table.dtype == np.uint8
    for r in range(k - 1):
        got = np.asarray(labels)
        assert np.array_equal(table[r].reshape(-1), got), r
        labels = pallas_eigh._slot_rotate(labels, 0)
    assert np.array_equal(np.asarray(labels), np.arange(k))
    # every unordered pair exactly once a sweep
    pairs = {frozenset(map(int, pq)) for pq in table.reshape(-1, 2)}
    assert len(pairs) == k * (k - 1) // 2


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-4)])
@pytest.mark.parametrize("k", [8, 16])
def test_plain_matches_interpreted_tpu_kernel(monkeypatch, k, dtype, tol):
    """The plain version against ``_build_proj_rr(k, 128, 128, 8, dtype)``
    in interpret mode: the same rotations in the same order, so f64 agrees
    to rounding (limit 1e-12 of max |X|) and f32 within 1e-4 of max |X|."""
    monkeypatch.setenv("COSMO_TPU_PALLAS_INTERPRET", "1")
    pallas_eigh._build_proj_rr.cache_clear()      # it reads the flag when built
    try:
        X = sym_stack(128, k, seed=k).astype(dtype)
        Yt = pallas_eigh._build_proj_rr(k, 128, 128, 8, dtype)(
            jnp.transpose(jnp.asarray(X), (1, 2, 0)))
        ref = np.transpose(np.asarray(Yt), (2, 0, 1))
    finally:
        pallas_eigh._build_proj_rr.cache_clear()
    got = R.psd_project_jacobi_rr_plain(torch.as_tensor(X), 8).numpy()
    assert got.dtype == X.dtype
    assert np.abs(got - ref).max() <= tol * np.abs(X).max()


def test_plain_reaches_eigh_accuracy():
    """10 sweeps of the round-parallel schedule reach f64 eigh accuracy:
    <= 1e-9, as the serial schedule (tests/test_torch_jacobi.py)."""
    X = sym_stack(24, 16, seed=5)
    got = R.psd_project_jacobi_rr_plain(torch.as_tensor(X), 10).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-9


def test_gate_sends_cpu_tensors_to_the_plain_rr_version(monkeypatch):
    """``COSMO_TPU_PALLAS_RR`` (read as pallas_eigh.py:277 reads it) sends
    the wrapper to the round-parallel version; on a CPU tensor that is its
    plain version and no launch is counted."""
    X = torch.as_tensor(sym_stack(9, 16, seed=1))
    serial = J.psd_project_pallas(X, 8)
    monkeypatch.setenv("COSMO_TPU_PALLAS_RR", "1")
    assert J.selected_kernel() == "jacobi_proj_rr"
    before = (J.psd_project_pallas.launches, R.psd_project_rr.launches)
    got = J.psd_project_pallas(X, 8)
    assert torch.equal(got, R.psd_project_jacobi_rr_plain(X, 8))
    assert not torch.equal(got, serial)            # another rounding order
    assert (got - serial).abs().max().item() <= 1e-12
    assert (J.psd_project_pallas.launches, R.psd_project_rr.launches) == before


@pytest.mark.parametrize("k", [3, 5, 50])
def test_gate_keeps_the_domain_rule(monkeypatch, k):
    """Under the gate, odd k and k outside 4..48 still go to eigh."""
    monkeypatch.setenv("COSMO_TPU_PALLAS_RR", "1")
    X = sym_stack(4, k, seed=k)
    got = J.psd_project_pallas(torch.as_tensor(X), 8).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-12


def test_disable_switch_sends_every_side_to_eigh(monkeypatch):
    """``COSMO_TPU_DISABLE_PALLAS`` (pallas_eigh.py:258) wins over the rr
    gate: every side goes to torch.linalg.eigh."""
    monkeypatch.setenv("COSMO_TPU_DISABLE_PALLAS", "1")
    monkeypatch.setenv("COSMO_TPU_PALLAS_RR", "1")
    assert J.selected_kernel() == "eigh"
    X = sym_stack(6, 16, seed=2)
    got = J.psd_project_pallas(torch.as_tensor(X), 2).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-12


def test_rr_cuda_entry_refuses_a_cpu_tensor():
    with pytest.raises(ValueError):
        R.jacobi_proj_rr_cuda(torch.as_tensor(sym_stack(2, 8, seed=0)), 8)
    with pytest.raises(ValueError):
        R.pair_table(7)


def test_decomposed_block_kkt_solve_through_the_rr_plain_version(monkeypatch):
    """The decomposed banded SDP through the block-diagonal KKT with
    eigh_backend="pallas" and COSMO_TPU_PALLAS_RR: every projection takes
    the round-parallel plain version on the CPU. It differs from the
    reference's LAPACK projection at rounding level, so the stop may fall
    at another check: the objective is held to 1e-5 relative, the solve's
    eps."""
    monkeypatch.setenv("COSMO_TPU_PALLAS_RR", "1")
    s = dict(decompose=True, accelerator=None, dtype=np.float64, eps_abs=1e-5,
             eps_rel=1e-5)
    rj = ct.Model(ct.Settings(**s)).set(
        *jprob.banded_sdp(200, 8, seed=0, sparse=True)[:5]).optimize()
    mt = pt.Model(pt.Settings(**s, eigh_backend="pallas"), device="cpu").set(
        *tprob.banded_sdp(200, 8, seed=0, sparse=True)[:5])
    rt = mt.optimize()
    assert rj.status == rt.status == "Solved"
    assert abs(rj.obj_val - rt.obj_val) <= 1e-5 * abs(rj.obj_val)
    assert mt.last_solve["kkt_solver"] == "blockdiag"
    assert mt.last_solve["jacobi_kernel"] == "jacobi_proj_rr"
    assert mt.last_solve["projections"] >= rt.iter
