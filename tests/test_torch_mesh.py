"""The device mesh of cosmo_tpu_torch (``parallel/``) held to the JAX
package's mesh (``cosmo_tpu.parallel``, tests/test_sharding.py) and to its
own single-process solve.

One group of 8 gloo ranks on the CPU runs every case once
(``_torch_mesh_ranks.run``, spawned: the ranks import neither JAX nor this
module); the JAX references run in this process on its 8 virtual CPU
devices meanwhile. The host functions of the layout are held to the JAX
package's with exact equality, without a spawn.
"""
import os
import pickle
import socket
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_mesh_ranks as R
import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu import solver as jsolver
from cosmo_tpu.ops import conedata as jcones
from cosmo_tpu.ops import linops as jlinops
from cosmo_tpu.parallel import make_mesh as jmake_mesh
from cosmo_tpu.parallel import mesh as jmesh
from cosmo_tpu.parallel import shard_problem as jshard_problem
from cosmo_tpu.settings import split_settings as jsplit
from cosmo_tpu_torch import chordal, problems
from cosmo_tpu_torch.ops import conedata, linops
from cosmo_tpu_torch.parallel import make_mesh
from cosmo_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

# the spawned group's time limit: ranks that disagree fail it
RANKS_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_solve(n_blocks, side, n, dtype, sparse=False, settings=R.PLAIN, seed=3,
               psd_pad_to=4):
    """cosmo_tpu's solve_jit of block_sdp over its 8-device mesh."""
    import jax.numpy as jnp

    kw = {} if seed is None else dict(seed=seed)
    P, q, A, b, sets = jprob.block_sdp(n_blocks=n_blocks, side=side, n=n, **kw)
    m = b.shape[0]
    cones = jcones.compile_cones(sets, dtype=dtype, psd_pad_to=psd_pad_to)
    static, dyn = jsplit(ct.Settings(**settings), m, n, dtype)
    if sparse:
        arrs = (jlinops.coo_from_scipy(sp.csr_matrix(P), dtype),
                jlinops.coo_from_scipy(sp.csr_matrix(A), dtype),
                jnp.asarray(q, dtype), jnp.asarray(b, dtype))
    else:
        arrs = tuple(jnp.asarray(v, dtype) for v in (P, A, q, b))
    z = (jnp.zeros(n, dtype), jnp.zeros(m, dtype), jnp.zeros(m, dtype))
    Ps, As, qs, bs, cs = jshard_problem(jmake_mesh(8), *arrs, cones)
    out = jsolver.solve_jit(Ps, As, qs, bs, cs, *z, dyn, static=static)
    return dict(x=np.asarray(out["x"]), s=np.asarray(out["s"]), iter=int(out["iter"]))


def _jax_maxcut():
    P, q, A, b, sets, _ = jprob.maxcut(n_nodes=40, density=0.12, seed=7, sparse=True)
    model = ct.Model(ct.Settings(**R.MAXCUT))
    model.set(P, q, A, b, sets)
    r = model.optimize(mesh=jmake_mesh(8))
    return dict(x=r.x, obj=r.obj_val, status=r.status)


class _Ranks:
    """The 8 spawned gloo ranks: started on creation, joined by the first
    :meth:`results`."""

    def __init__(self, out: str):
        self.out = out
        self.ctx = mp.start_processes(R.run, args=(R.RANKS, _free_port(), out),
                                      nprocs=R.RANKS, join=False, start_method="spawn")
        self.ranks = None

    def results(self):
        """Each rank's results (the cases' dicts), in rank order."""
        if self.ranks is None:
            deadline = time.monotonic() + RANKS_TIMEOUT_S
            while not self.ctx.join(timeout=1):
                assert time.monotonic() < deadline, "the mesh ranks did not finish"
            self.ranks = []
            for r in range(R.RANKS):
                with open(os.path.join(self.out, f"rank{r}.pkl"), "rb") as f:
                    self.ranks.append(pickle.load(f))
        return self.ranks

    def close(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.terminate()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawned ranks. The module's first test starts them, so that the
    tests and references that run in this process overlap their work."""
    group = _Ranks(str(tmp_path_factory.mktemp("mesh")))
    yield group
    group.close()


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's mesh solves of the cases that compare to them."""
    return dict(
        dense=_jax_solve(8, 4, 16, np.float64),
        cg=_jax_solve(2 * R.RANKS, 4, 32, np.float32, sparse=True,
                      settings=R.DRYRUN, seed=None, psd_pad_to=8),
        maxcut=_jax_maxcut(),
    )


@pytest.fixture(scope="module")
def run(ranks, jax_ref):
    return dict(ranks=ranks.results(), jax=jax_ref)


@pytest.fixture(scope="module")
def single():
    """The port's single-process results of the cases that compare to it."""
    return {name: R.CASES[name](None)
            for name in ("dense", "uneven", "maxcut", "coo", "blockkkt", "cg",
                         "projection")}


def _rank0(run, name):
    return run["ranks"][0][name]


# ---- case 5: psd_cost_report on the maxcut-10k layout (host only)

def test_cost_report_maxcut_10k_layout(ranks, single):
    # first in the module: it starts the ranks (``ranks``) and runs here,
    # as the single-process references do, while they work
    P, q, A, b, sets, _ = problems.maxcut(n_nodes=10_000, density=4.0 / 10_000,
                                          seed=0, sparse=True)
    info = chordal.decompose(P, q, A, b, sets, pt.Settings(decompose=True),
                             pad_batch=8)
    cones = conedata.compile_cones(info.problem[4], dtype=np.float32, psd_pad_to=8,
                                   device="cpu")
    rep = tmesh.psd_cost_report(cones, 8)
    assert rep["imbalance"] == 1.0
    assert rep["pad_waste"] <= 1.2, rep
    giant = [bk for bk in rep["buckets"] if bk["k"] >= 512]
    assert giant and all(bk["layout"] == "matrix_sharded" for bk in giant)
    assert rep == jmesh.psd_cost_report(cones, 8)


# ---- case 1: block_sdp(8, 4, 16), plain ADMM, the dense KKT (row-sharded A)

def test_dense_block_sdp_matches_jax_mesh(run):
    got, ref = _rank0(run, "dense"), run["jax"]["dense"]
    assert got["A_layout"] == "RowShard"      # m = 80 divides 8 ranks
    assert got["iter"] == ref["iter"]
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-6, atol=1e-8)


def test_dense_block_sdp_matches_single_process(run, single):
    got, ref = _rank0(run, "dense"), single["dense"]
    assert got["iter"] == ref["iter"]
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-6, atol=1e-8)


# ---- case 2: 11 blocks over 8 ranks (dump-block padding, replicated A)

def test_uneven_blocks_bit_identical(run, single):
    got, ref = _rank0(run, "uneven"), single["uneven"]
    assert got["A_layout"] == "Tensor"        # m = 66 does not divide 8
    assert got["iter"] == ref["iter"]
    np.testing.assert_array_equal(got["x"], ref["x"])
    np.testing.assert_array_equal(got["s"], ref["s"])


# ---- case 3: the decomposed sparse maxcut(40) through Model.optimize(mesh)

def test_decomposed_maxcut_matches_jax_mesh(run):
    got, ref = _rank0(run, "maxcut"), run["jax"]["maxcut"]
    assert got["decomposed"] and got["kkt"] == "blockdiag"
    assert got["status"] == ref["status"] == "Solved"
    assert abs(got["obj"] - ref["obj"]) < 1e-6 * max(1.0, abs(ref["obj"]))
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-5, atol=1e-6)


def test_decomposed_maxcut_matches_single_process(run, single):
    got, ref = _rank0(run, "maxcut"), single["maxcut"]
    assert got["status"] == ref["status"] == "Solved"
    assert abs(got["obj"] - ref["obj"]) < 1e-6 * max(1.0, abs(ref["obj"]))
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-5, atol=1e-6)


def test_decomposed_maxcut_rerun_bit_identical(run):
    # the second solve on the same model: every cache hits
    first = _rank0(run, "maxcut")
    again = first["again"]
    assert first["iter"] == again["iter"]
    for a in ("x", "y", "s"):
        np.testing.assert_array_equal(first[a], again[a])


# ---- case 4: the layout guarantees on maxcut(60, 0.1, seed 3)

def test_layout_keeps_fast_paths(run):
    got = _rank0(run, "layout")
    assert got["decomposed"] and got["buckets"]
    for bk in got["buckets"]:
        assert bk["fastpath"] != "none", bk
        # fewer blocks than ranks: the batch on every rank, the polar's
        # products split over the matrix rows; else a share of the batch
        assert bk["batch"] < R.RANKS if bk["split"] else bk["batch"] >= 1


def test_layout_cost_report(run):
    rep = _rank0(run, "layout")["report"]
    assert rep is not None and rep["imbalance"] == 1.0 and rep["pad_waste"] >= 1.0
    split = {bk["side"]: bk for bk in _rank0(run, "layout")["buckets"]}
    for bk in rep["buckets"]:
        if bk["layout"] == "batch_sharded":
            assert bk["B_padded"] % R.RANKS == 0
            assert bk["local_per_device"] == bk["B_padded"] // R.RANKS
            assert split[bk["k"]]["batch"] * R.RANKS == bk["B_padded"]
        else:
            assert split[bk["k"]]["split"]


# ---- case 6: sharded Coo products, bit-exact

def test_sharded_coo_products_bit_exact(run, single):
    got, ref = _rank0(run, "coo"), single["coo"]
    for k in ("mv", "rmv", "colmax", "rowmax"):
        np.testing.assert_array_equal(got[k], ref[k])


# ---- case 7: the block KKT's factor and solve split by component

def test_sharded_blockkkt_factor_solve(run, single):
    got, ref = _rank0(run, "blockkkt"), single["blockkkt"]
    # the components padded to a multiple of 8 and split evenly; each rank
    # holds the pairs of its own components only, which together are the
    # unsharded pair lists
    assert all(n >= 1 for n in got["local_components"])
    for r_ in run["ranks"]:
        bk = r_["blockkkt"]
        assert bk["local_components"] == got["local_components"]
        assert bk["targets_local"]
    assert (np.sum([r_["blockkkt"]["pairs"] for r_ in run["ranks"]], axis=0).tolist()
            == ref["pairs"])
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got["nu"], ref["nu"], rtol=1e-12, atol=1e-12)


# ---- case 8: the dryrun's sparse Coo + CG case in float32

def test_sparse_cg_matches_jax_mesh(run):
    got, ref = _rank0(run, "cg"), run["jax"]["cg"]
    assert got["A_layout"] == "Coo" and got["iter"] == ref["iter"]
    np.testing.assert_allclose(got["x"], ref["x"], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got["s"], ref["s"], rtol=2e-4, atol=1e-5)


def test_sparse_cg_bit_identical_to_single_process(run, single):
    got, ref = _rank0(run, "cg"), single["cg"]
    assert got["iter"] == ref["iter"]
    for a in ("x", "y", "s"):
        np.testing.assert_array_equal(got[a], ref[a])


# ---- the projection of every sharded cone family, and its membership tests

def test_sharded_projection_matches_single_process(run, single):
    got, ref = _rank0(run, "projection"), single["projection"]
    assert got["split"] == [False, True]      # side 3: 9 blocks; side 6: 3
    np.testing.assert_allclose(got["s"], ref["s"], rtol=1e-12, atol=1e-12)
    assert got["in_pol"] == ref["in_pol"]
    np.testing.assert_allclose(got["support"], ref["support"], rtol=1e-12)


# ---- case 9: every rank returns the same bits

@pytest.mark.parametrize("case", ["dense", "uneven", "maxcut", "coo", "blockkkt",
                                  "cg", "projection"])
def test_ranks_bit_identical(run, case):
    keys = {"coo": ("mv", "rmv", "colmax", "rowmax"), "blockkkt": ("x", "nu"),
            "projection": ("s",)}.get(case, ("x", "y", "s"))
    first = run["ranks"][0][case]
    for r, res in enumerate(run["ranks"][1:], start=1):
        for k in keys:
            np.testing.assert_array_equal(res[case][k], first[k], err_msg=f"rank {r} {k}")


# ---- the host functions, held to the JAX package's on seeded inputs

def _sorted_keys(seed, nnz=200, segs=37):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, segs, nnz))


@pytest.mark.parametrize("seed,d", [(0, 8), (1, 3), (2, 8), (3, 1)])
def test_align_bounds_and_triplets_match_jax(seed, d):
    key = _sorted_keys(seed)
    rng = np.random.default_rng(seed + 10)
    other = rng.integers(0, 50, key.size)
    vals = rng.standard_normal(key.size)
    assert tmesh._align_bounds(key, d) == jmesh._align_bounds(key, d)
    for a, b in zip(tmesh._align_triplets(key, other, vals, d),
                    jmesh._align_triplets(key, other, vals, d)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d", [2, 8])
def test_coo_shard_remap_matches_jax(d):
    A = sp.random(61, 29, density=0.2, random_state=4, format="csr")
    tA = linops.coo_from_scipy(A, np.float64)
    jA = jlinops.coo_from_scipy(A, np.float64)
    np.testing.assert_array_equal(tmesh.coo_shard_remap(tA, d), jmesh.coo_shard_remap(jA, d))


@pytest.mark.parametrize("d", [1, 3, 8])
def test_psd_cost_report_matches_jax(d):
    sets, _ = R.mixed_cones()
    cones = conedata.compile_cones(sets, dtype=np.float64, psd_pad_to=1, device="cpu")
    assert tmesh.psd_cost_report(cones, d) == jmesh.psd_cost_report(cones, d)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()


def test_make_mesh_raises_for_too_few_ranks(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="only 1"):
            make_mesh(2)
    finally:
        dist.destroy_process_group()
