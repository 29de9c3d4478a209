"""The fifth slice of cosmo_tpu_torch as a whole: a decomposed maxcut SDP
at the settings of ``bench.py``'s maxcut benchmarks (eps 1e-5, max_iter
20000, decomposition, every other option at its default: Anderson
acceleration, the certificates, the refine latch in float32), against
cosmo_tpu on the CPU.

``maxcut(300, 0.02, seed=0)`` is the smallest of the family whose largest
clique needs a large-side layout: its decomposition has PSD buckets of
sides 8, 16, 24, 32 and one block of side 96, on the shear layout at the
default ``colpad_min`` (512) and on the colpad layout at ``colpad_min=96``.
The block-diagonal KKT takes it, as it takes maxcut-2000 and -10k.

In float64 both packages run the same algorithm; Anderson acceleration
amplifies rounding, so the objectives are held to the solve's own
tolerance (1e-5 relative). float32, the card's default, is held to the
reference's float64 objective within the 1e-4 float32 regime."""
import numpy as np
import pytest
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob

torch.set_num_threads(1)

MAXCUT_BENCH = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000, decompose=True)


def _maxcut(prob):
    return prob.maxcut(300, 0.02, seed=0, sparse=True)[:5]


@pytest.fixture(scope="module")
def reference():
    """The JAX package's float64 solve (its layouts give the same problem,
    so one reference holds both of the port's)."""
    return ct.Model(ct.Settings(**MAXCUT_BENCH, dtype=np.float64)).set(
        *_maxcut(jprob)).optimize()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("colpad_min,layout", [(512, "shear"), (96, "colpad")])
def test_maxcut_default_settings_match_reference(reference, colpad_min, layout, dtype):
    rj = reference
    mt = pt.Model(pt.Settings(**MAXCUT_BENCH, colpad_min=colpad_min, dtype=dtype),
                  device="cpu").set(*_maxcut(tprob))
    rt = mt.optimize()
    buckets = mt._dev_cache["cones"].psd_buckets
    assert [(b.side, b.fastpath) for b in buckets] == [
        (8, "matmul"), (16, "matmul"), (24, "matmul"), (32, "matmul"), (96, layout)]
    info = mt.last_solve
    assert info["kkt_solver"] == "blockdiag" and info["n_accelerated"] > 0
    assert rj.status == rt.status == "Solved"
    tol = 1e-5 if dtype == np.float64 else 1e-4
    assert abs(rt.obj_val - rj.obj_val) <= tol * abs(rj.obj_val)
    if dtype == np.float32:
        assert rt.x.dtype == np.float32 and info["refine_iter"] > 0
