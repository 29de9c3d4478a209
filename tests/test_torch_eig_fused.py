"""The amortized PSD projection at the sides of the kernel ``jacobi_eig``
(even 4..48), which computes all of ``cosmo_tpu.ops.eigh.
psd_project_amortized`` in one launch: its plain version against the JAX
function, the kernel's deferred sweep decision in the plain version, the
bound of ``chip_smoke.py``'s kernels line, and the CPU route's independence
from the kernels' library. The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py 10a)."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmo_tpu.ops import eigh as jeigh
from cosmo_tpu_torch.kernel_timing import eig_case
from cosmo_tpu_torch.ops import cuda_build
from cosmo_tpu_torch.ops import eigh as teigh
from cosmo_tpu_torch.ops import jacobi_eig as JE

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

# the JAX function, compiled once a shape (both regimes share it)
_jax_amortized = jax.jit(jeigh.psd_project_amortized, static_argnums=(2, 3))


def _rec(X, V):
    """V diag(V'XV) V': unchanged by rotations among the eigenvectors of
    nearly equal eigenvalues, which float32 rounding does not determine."""
    d = torch.diagonal(V.transpose(1, 2) @ X @ V, dim1=1, dim2=2)
    return V @ (d[:, :, None] * V.transpose(1, 2))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("k", range(4, 49, 2))
def test_plain_version_matches_reference(k, dtype, tol):
    """eigh.psd_project_amortized through the wrapper on the CPU against
    the JAX function, B in {1, 31}, warm (V_prev near X's eigenbasis: 2
    sweeps) and stale (V_prev = I: 8), each regime as the staleness rule
    classes it: P and V diag(V'XV) V' within ``tol`` of max |X|, V itself in
    float64. The JAX function runs once a regime on the two cases stacked
    (the same sweep decision as each alone)."""
    for warm in (True, False):
        cases = [eig_case(B, k, warm, seed=100 * k + B + warm) for B in (1, 31)]
        X = np.concatenate([c[0] for c in cases]).astype(dtype)
        V = np.concatenate([c[2] for c in cases]).astype(dtype)
        jP, jV = _jax_amortized(jnp.asarray(X), jnp.asarray(V), 2, 8)
        jP, jV = torch.as_tensor(np.array(jP)), torch.as_tensor(np.array(jV))
        start = 0
        for B in (1, 31):
            Xt = torch.as_tensor(X[start:start + B])
            Vt = torch.as_tensor(V[start:start + B])
            assert bool(teigh.amortized_rotate(Xt, Vt)[2]) != warm
            tP, tV = JE.psd_project_amortized(Xt, Vt, 2, 8)
            rP, rV = jP[start:start + B], jV[start:start + B]
            start += B
            scale = Xt.abs().max().item()
            assert (tP - rP).abs().max().item() <= tol * scale, (warm, B)
            assert (_rec(Xt, tV) - _rec(Xt, rV)).abs().max().item() <= tol * scale, (warm, B)
            if dtype == np.float64:
                assert (tV - rV).abs().max().item() <= tol * scale, (warm, B)


def _deferred(X, V_prev, warm, full):
    """The plain version in the kernel's order: the rotation, the sweeps
    before the decision (``warm``, or 0 when full < warm), the flag, the
    rest, the reconstruction."""
    W, V0, stale = teigh.amortized_rotate(X, V_prev)
    pre = warm if full >= warm else 0
    W, V = teigh.jacobi_sweeps(W.clone(), V0.clone(), pre)
    W, V = teigh.jacobi_sweeps(W, V, (full if bool(stale) else warm) - pre)
    return teigh.sym_reconstruct(torch.diagonal(W, dim1=-2, dim2=-1), V), V


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [4, 6, 16, 18, 48])
def test_deferred_decision_gives_the_same_bits(k, dtype):
    """Warm sweeps before the decision and full - warm more after it give
    the full sweeps' P and V bit for bit (and, with full < warm, the
    decision before any sweep), in both regimes: the kernel may sweep
    before the grid barrier that settles the flag."""
    for warm in (True, False):
        X, _, V = eig_case(5, k, warm, seed=k + warm)
        X = torch.as_tensor(X, dtype=dtype)
        V = torch.as_tensor(np.ascontiguousarray(V), dtype=dtype)
        for warm_sweeps, full_sweeps in ((2, 8), (3, 1)):
            ref = teigh.psd_project_amortized(X, V, warm_sweeps, full_sweeps)
            got = _deferred(X, V, warm_sweeps, full_sweeps)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_amortized_bound_by_hand():
    """chip_smoke.amortized_bound_ms at [2498, 16] float64, 2 sweeps, by
    hand: eig_bound_ms's work (2 x 15 x 8 rotations of 18 x 16 + 20 flops,
    P's symmetrisation 256) and the mass sums (2 x 256 + 2 x 16) at 34
    TFLOP/s, the reconstruction and the rotation's four products (10 x 16^3)
    at 67, over 2,498 matrices: 7.017 us; the bytes (four arrays of 2,498 x
    256 doubles) at 3.35 TB/s: 6.109 us. The operations bound it."""
    elementwise = 2498 * (2 * 15 * 8 * (18 * 16 + 20) + 256 + 2 * 256 + 2 * 16)
    products = 2498 * 10 * 16**3
    ops_ms = 1e3 * (elementwise / 34e12 + products / 67e12)
    bytes_ms = 1e3 * 4 * 2498 * 256 * 8 / 3.35e12
    assert abs(bytes_ms - 0.0061085) < 1e-6
    bound, by = chip_smoke.amortized_bound_ms(2498, 16, "float64", 2)
    assert by == "operations" and abs(bound - ops_ms) < 1e-12
    assert abs(bound - 0.0070169) < 1e-6
    # the kernel's sweeps and reconstruction alone (eig_bound_ms) are
    # bytes-bound at the same shape
    eig_ms, eig_by = chip_smoke.eig_bound_ms(2498, 16, "float64", 2)
    assert eig_by == "bytes" and abs(eig_ms - bytes_ms) < 1e-12


def test_cpu_route_never_builds_the_library(monkeypatch):
    """On CPU tensors the wrapper runs the plain version at every side (the
    kernel's 4..48, the large sides, an odd side) and neither builds nor
    loads the kernels' library; the launcher refuses a CPU tensor before
    any build."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route reached the CUDA library")

    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "jacobi_library", refuse)
    JE.reset_counts()
    for k in (4, 16, 18, 48, 50, 5):
        X, _, V = eig_case(3, k, True, seed=k)
        P, V1 = JE.psd_project_amortized(torch.as_tensor(X),
                                         torch.as_tensor(np.ascontiguousarray(V)))
        assert P.shape == V1.shape == (3, k, k) and bool(torch.isfinite(P).all())
    assert not JE.psd_project_amortized.launches
    X = torch.zeros(2, 16, 16, dtype=torch.float64)
    with pytest.raises(ValueError):
        JE.jacobi_eig_cuda(X, X.clone(), 2, 8)
