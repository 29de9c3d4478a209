"""The Jacobi PSD projection of cosmo_tpu_torch (ops/jacobi_proj.py).

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
here to ``cosmo_tpu.ops.eigh.psd_project_jacobi(X, sweeps, "vec")``, the JAX
package's implementation of the same round-robin schedule (the serial
Pallas kernel has no interpret mode and falls back to eigh off-TPU, so it
cannot be the reference here). The CUDA kernel itself is held to the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmo_tpu.ops import eigh as jeigh
from cosmo_tpu_torch.ops import jacobi_proj as J

from _torch_port import eigh_projection, sym_stack

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [4, 8, 16, 48])
def test_plain_matches_jax_jacobi(k):
    """f64, same schedule and guards; only the order of the k/2 disjoint
    rotations inside a round may round differently: <= 1e-10. One JAX
    call at B = 130 gives the reference for every B (blocks are
    independent)."""
    X = sym_stack(130, k, seed=k)
    ref = np.asarray(jeigh.psd_project_jacobi(jnp.asarray(X), 8, "vec"))
    for B in (1, 7, 130):
        got = J.psd_project_pallas(torch.as_tensor(X[:B]), 8).numpy()
        assert got.shape == (B, k, k)
        assert np.abs(got - ref[:B]).max() <= 1e-10


def test_plain_matches_eigh_projection():
    """10 sweeps reach f64 eigh accuracy: <= 1e-9, as tests/test_eigh.py."""
    X = sym_stack(24, 16, seed=3)
    got = J.psd_project_jacobi_plain(torch.as_tensor(X), 10).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-9


@pytest.mark.parametrize("k", [8, 16])
def test_f32_within_documented_floor(k):
    """f32 Jacobi carries a ~1e-5 relative backward-error floor
    (cosmo_tpu/ops/conedata.py resolve_eigh_backend: 6e-6 at k = 8,
    1.7e-5 at k = 16): the f32 projection stays within 2e-5 of the f64 one,
    relative to the input's largest entry."""
    X = sym_stack(64, k, seed=11)
    y64 = J.psd_project_jacobi_plain(torch.as_tensor(X), 8).numpy()
    y32 = J.psd_project_pallas(torch.as_tensor(X, dtype=torch.float32), 8)
    assert y32.dtype == torch.float32
    assert np.abs(y32.double().numpy() - y64).max() <= 2e-5 * np.abs(X).max()


@pytest.mark.parametrize("k", [2, 5, 50])
def test_shape_rule_sends_other_sides_to_eigh(k):
    """Odd k, k < 4 and k > 48 are outside the kernel's domain
    (pallas_eigh.py:257-266): exact eigh projection, f64 1e-12."""
    assert not J.kernel_takes(k)
    X = sym_stack(5, k, seed=k)
    got = J.psd_project_pallas(torch.as_tensor(X), 8).numpy()
    assert np.abs(got - eigh_projection(X)).max() <= 1e-12


def test_domain_rule():
    assert [k for k in range(1, 60) if J.kernel_takes(k)] == list(range(4, 49, 2))


def test_cpu_tensor_never_counts_a_launch():
    before = J.psd_project_pallas.launches
    J.psd_project_pallas(torch.as_tensor(sym_stack(3, 8, seed=0)), 8)
    J.psd_project_pallas(torch.as_tensor(sym_stack(3, 5, seed=0)), 8)
    assert J.psd_project_pallas.launches == before


def test_pair_schedule_matches_reference():
    from cosmo_tpu.ops import pallas_eigh

    for k in (4, 16, 48):
        assert np.array_equal(J.pair_schedule(k), pallas_eigh._pair_schedule(k))


def test_cuda_entry_refuses_a_cpu_tensor():
    with pytest.raises(ValueError):
        J.jacobi_proj_cuda(torch.as_tensor(sym_stack(2, 8, seed=0)), 8)
