"""The cases of tests/test_torch_mesh.py as functions of a mesh (None: the
single-process solve), and the body of each spawned rank.

The ranks are spawned processes that import this module: it imports only
torch, numpy, scipy and cosmo_tpu_torch (never JAX, which the test module
imports)."""
import datetime
import os
import pickle

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

import cosmo_tpu_torch as pt
from cosmo_tpu_torch import problems, solver
from cosmo_tpu_torch.models import cones as C
from cosmo_tpu_torch.ops import blockkkt, conedata, linops, projections
from cosmo_tpu_torch.settings import Settings, split_settings

RANKS = 8
CPU = torch.device("cpu")
# the settings of tests/test_sharding.py and __graft_entry__.dryrun_multichip
PLAIN = dict(max_iter=200, accelerator=None, adaptive_rho=False,
             eps_abs=1e-6, eps_rel=1e-6)
MAXCUT = dict(eps_abs=1e-7, eps_rel=1e-7, decompose=True, max_iter=3000)
DRYRUN = dict(max_iter=10, check_termination=5, accelerator=None,
              adaptive_rho=False, scaling=3, kkt_solver="cg")


def _solve(P, A, q, b, cones, settings, dtype, mesh):
    """solver.solve of the data (dense arrays or host Coo) from zero starts,
    sharded over ``mesh`` when given."""
    m, n = b.shape[0], q.shape[0]
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    static, dyn = split_settings(settings, m, n, dtype, device=CPU)
    z = [torch.zeros(k, dtype=tdt) for k in (n, m, m)]
    if mesh is not None:
        from cosmo_tpu_torch.parallel import shard_problem

        args = shard_problem(mesh, P, A, q, b, cones, dtype=tdt)
    else:
        def dev(M):
            if isinstance(M, linops.Coo):
                return linops.coo_to_device(M, CPU, tdt)
            return torch.as_tensor(M, dtype=tdt)

        args = (dev(P), dev(A), dev(q), dev(b), conedata.to_device(cones, CPU, tdt))
    out = solver.solve(*args, *z, dyn, static)
    return dict(x=out["x"], y=out["y"], s=out["s"], iter=out["iter"],
                A_layout=type(args[1]).__name__)


def block_sdp_case(n_blocks, side, n, mesh=None):
    """tests/test_sharding.py::_prepare: plain ADMM, the dense KKT."""
    P, q, A, b, sets = problems.block_sdp(n_blocks=n_blocks, side=side, n=n, seed=3)
    cones = conedata.compile_cones(sets, dtype=np.float64, psd_pad_to=4, device=CPU)
    return _solve(P, A, q, b, cones, Settings(**PLAIN), np.float64, mesh)


def cg_case(mesh=None):
    """The dryrun's first case: sparse Coo data through CG with the
    compensated restarts, in float32 (__graft_entry__.py:112-124)."""
    P, q, A, b, sets = problems.block_sdp(n_blocks=2 * RANKS, side=4, n=32)
    cones = conedata.compile_cones(sets, dtype=np.float32, psd_pad_to=8, device=CPU)
    Pc, Ac = (linops.coo_from_scipy(sp.csr_matrix(M), np.float32) for M in (P, A))
    return _solve(Pc, Ac, q, b, cones, Settings(**DRYRUN), np.float32, mesh)


def maxcut_model_case(mesh=None, again: bool = False):
    """The decomposed sparse maxcut(40) through Model.optimize; ``again``:
    then a second solve on the same model (every cache hits), as
    ``again``."""
    P, q, A, b, sets, _ = problems.maxcut(n_nodes=40, density=0.12, seed=7, sparse=True)
    model = pt.Model(pt.Settings(**MAXCUT), device="cpu")
    model.set(P, q, A, b, sets)
    r = model.optimize(mesh=mesh)
    out = dict(x=r.x, y=r.y, s=r.s, obj=r.obj_val, iter=r.iter, status=r.status,
               decomposed=model.is_decomposed, kkt=model.last_solve["kkt_solver"],
               collectives=model.last_solve["collectives"])
    if again:
        r = model.optimize(mesh=mesh)
        out["again"] = dict(x=r.x, y=r.y, s=r.s, iter=r.iter)
    return out


def layout_case(mesh):
    """maxcut(60) through Model on the mesh, 5 plain iterations: each PSD
    bucket's fast path, batch on this rank and split, and the cost report."""
    from cosmo_tpu_torch.parallel import mesh as mesh_mod

    P, q, A, b, sets, _ = problems.maxcut(n_nodes=60, density=0.1, seed=3, sparse=True)
    model = pt.Model(pt.Settings(decompose=True, max_iter=5, accelerator=None),
                     device="cpu")
    model.set(P, q, A, b, sets)
    model.optimize(mesh=mesh)
    buckets = [dict(side=bk.side, fastpath=bk.fastpath, batch=bk.batch,
                    split=bk.split is not None)
               for bk in model._dev_cache["cones"].psd_buckets]
    return dict(buckets=buckets, report=mesh_mod.LAST_SHARD_REPORT,
                decomposed=model.is_decomposed)


def coo_case(mesh=None):
    """tests/test_sharding.py::test_sharded_coo_matvec_bitexact's data."""
    rng = np.random.default_rng(11)
    A = linops.coo_from_scipy(sp.random(103, 57, density=0.15, random_state=11,
                                        format="csr"), np.float64)
    x = torch.as_tensor(rng.standard_normal(57))
    y = torch.as_tensor(rng.standard_normal(103))
    if mesh is not None:
        from cosmo_tpu_torch.parallel import shard_coo

        Ad = shard_coo(mesh, A)
    else:
        Ad = linops.coo_to_device(A, CPU, torch.float64)
    return dict(mv=linops.matvec(Ad, x).numpy(), rmv=linops.rmatvec(Ad, y).numpy(),
                colmax=linops.colmax_abs(Ad).numpy(), rowmax=linops.rowmax_abs(Ad).numpy())


def decomposed_maxcut40():
    """The decomposed problem of maxcut(40, 0.12, seed 7), single process."""
    P, q, A, b, sets, _ = problems.maxcut(n_nodes=40, density=0.12, seed=7, sparse=True)
    m0 = pt.Model(pt.Settings(decompose=True, max_iter=1, accelerator=None), device="cpu")
    m0.set(P, q, A, b, sets)
    m0.optimize()
    Pc, qc, Ac, bc, _sets = m0._chordal_info.problem
    return sp.csr_matrix(Pc), sp.csr_matrix(Ac)


def blockkkt_case(mesh=None):
    """tests/test_sharding.py::test_sharded_blockkkt_factor_solve_bitexact:
    one factor and one solve of the block KKT on seeded rho and right-hand
    sides."""
    Pc, Ac = decomposed_maxcut40()
    meta = blockkkt.analyze(Pc, Ac, max_block=64)
    Pd = linops.coo_from_scipy(Pc, np.float64)
    Ad = linops.coo_from_scipy(Ac, np.float64)
    rng = np.random.default_rng(0)
    mdim, n = Ac.shape
    rho_vec = torch.as_tensor(np.abs(rng.standard_normal(mdim)) + 0.1)
    r1 = torch.as_tensor(rng.standard_normal(n))
    r2 = torch.as_tensor(rng.standard_normal(mdim))
    sigma = torch.tensor(1e-6, dtype=torch.float64)
    Pdev = linops.coo_to_device(Pd, CPU, torch.float64)
    if mesh is not None:
        from cosmo_tpu_torch.parallel import shard_blockkkt, shard_coo

        meta_d, Adev = shard_blockkkt(mesh, meta, Ad), shard_coo(mesh, Ad)
    else:
        meta_d = blockkkt.meta_to_device(meta, CPU)
        Adev = linops.coo_to_device(Ad, CPU, torch.float64)
    st = blockkkt.factor(meta_d, Pdev, Adev, sigma, rho_vec)
    x, nu = blockkkt.solve(meta_d, st, Pdev, Adev, sigma, rho_vec, r1, r2)
    return dict(x=x.numpy(), nu=nu.numpy(), local_components=[
        int(b.cols.shape[0]) for b in meta_d.buckets],
        pairs=[[int(b.a_tgt.numel()), int(b.p_tgt.numel())] for b in meta_d.buckets],
        targets_local=all(bool((t < b.N * b.k * b.k).all()) for b in meta_d.buckets
                          for t in (b.a_tgt, b.p_tgt)))


def mixed_cones():
    """Every cone family the projection shards, with a PSD bucket of fewer
    blocks than ranks (side 6, 3 blocks: its polar's products split over
    the matrix rows) and one of an uneven count (side 3, 9 blocks)."""
    rng = np.random.default_rng(5)
    box_l = -np.abs(rng.standard_normal(4))
    sets = ([C.ZeroSet(3), C.Nonnegatives(5), C.Box(box_l, -box_l)]
            + [C.SecondOrderCone(4) for _ in range(3)]
            + [C.SecondOrderCone(7) for _ in range(9)]
            + [C.PsdConeTriangle(21) for _ in range(3)]
            + [C.PsdConeTriangle(6) for _ in range(9)]
            + [C.ExponentialCone() for _ in range(5)]
            + [C.DualExponentialCone() for _ in range(2)]
            + [C.PowerCone(0.3) for _ in range(4)] + [C.DualPowerCone(0.7)])
    return sets, sum(s.dim for s in sets)


def projection_case(mesh=None):
    """The projection of a seeded vector onto the mixed cones with the
    polar backend, and the membership tests' verdicts."""
    sets, m = mixed_cones()
    cones = conedata.compile_cones(sets, dtype=np.float64, psd_pad_to=1,
                                   eigh_backend="polar", device=CPU)
    if mesh is not None:
        from cosmo_tpu_torch.parallel import shard_cones

        cones = shard_cones(mesh, cones)
    else:
        cones = conedata.to_device(cones, CPU, torch.float64)
    v = torch.as_tensor(np.random.default_rng(6).standard_normal(m))
    s, _ = projections.project(v, cones)
    tols = (torch.tensor(1e-3, dtype=torch.float64), torch.tensor(10.0, dtype=torch.float64))
    inside = projections.in_pol_recc_multi(-s, cones, tols)
    sup = projections.support_function_multi(v - s, cones, tols)
    return dict(s=s.numpy(), in_pol=[bool(f) for f in inside],
                support=[float(t) for t in sup],
                split=[bk.split is not None for bk in cones.psd_buckets])


CASES = {
    "dense": lambda mesh: block_sdp_case(8, 4, 16, mesh),
    "uneven": lambda mesh: block_sdp_case(11, 3, 13, mesh),
    "maxcut": lambda mesh: maxcut_model_case(mesh, again=True),
    "layout": layout_case,
    "coo": coo_case,
    "blockkkt": blockkkt_case,
    "cg": cg_case,
    "projection": projection_case,
}


def run(rank, world, port, outdir):
    """One rank: every case on one gloo group, results pickled to
    ``outdir/rank<r>.pkl``."""
    from cosmo_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    # gloo on the loopback interface: the host's name may not resolve here
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(world)
        out = {name: case(mesh) for name, case in CASES.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
