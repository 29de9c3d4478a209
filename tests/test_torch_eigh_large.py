"""The amortized PSD backend at every side: cosmo_tpu_torch against
cosmo_tpu in float64 on the CPU.

On a CUDA device the amortized projection takes sides 4..48 through the
kernel ``jacobi_eig``, side 2 and the sides above 48 through
``jacobi_eig_cluster`` (``csrc/jacobi_eig_cluster.cu``) where W fits a
cluster's shared memory and ``jacobi_eig_large``
(``csrc/jacobi_eig_large.cu``) past that, and an odd side through the
reference's eigh branch (``tests/test_torch_eig_cluster.py`` holds the
cluster kernel's scheme). Here: ``compile_cones`` for the card
at those sides; the plain version (the kernels' function) against the JAX
projection at k = 2, 50 and 56, warm and stale, within 1e-10 of max |X|;
the odd side, where the reference ignores the carried basis (ROADMAP Queue
3), without a host read of the stale flag; the uint16 pair table; the
large kernel's round scheme (ping-pong W buffers, the symmetrisation folded
into the next sweep's first round) emulated in torch against the plain
version bit for bit; and an amortized solve with a side-56 bucket against
the reference's. The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py 10e)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu.ops import conedata as jcd
from cosmo_tpu.ops import eigh as jeigh
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.ops import conedata as tcd
from cosmo_tpu_torch.ops import eigh as teigh
from cosmo_tpu_torch.ops import jacobi_eig as JE
from cosmo_tpu_torch.ops import jacobi_proj as J

from _torch_port import sym_stack

torch.set_num_threads(1)

# the JAX projection, compiled once a side (warm and stale share it: the
# sweep count is traced)
_jax_amortized = jax.jit(jeigh.psd_project_amortized, static_argnums=(2, 3))


def _near(got, ref, scale, tol=1e-10):
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err <= tol * scale, err


def _amortized_case(B, k, warm, seed):
    """(X, V_prev) of one projection: X symmetric Gaussian; stale, V_prev =
    I; warm, V_prev X's eigenbasis turned by an orthogonal matrix near I,
    at angles ~0.01 sqrt(48 / k), which keeps a block's off-diagonal mass
    under the staleness rule's 9% at every side."""
    rng = np.random.default_rng(seed)
    X = sym_stack(B, k, seed)
    if not warm:
        return X, np.broadcast_to(np.eye(k), (B, k, k)).copy()
    R = rng.standard_normal((B, k, k)) * 0.01 * min(1.0, np.sqrt(48 / k))
    R, _ = np.linalg.qr(np.eye(k) + (R - R.swapaxes(1, 2)))
    return X, np.linalg.eigh(X)[1] @ R


@pytest.mark.parametrize("side,pad,kernels", [
    (2, 1, ("jacobi_eig_cluster", "jacobi_eig_cluster")), (5, 1, (None, None)),
    (56, 1, ("jacobi_eig_cluster", "jacobi_eig_cluster")),
    (896, 8, ("jacobi_eig_cluster", "jacobi_eig_large")),
    (48, 8, ("jacobi_eig", "jacobi_eig"))])
def test_amortized_compiles_every_side_for_cuda(side, pad, kernels):
    """compile_cones(eigh_backend="amortized") for the card takes every
    side (side 2, 56 and odd sides appear with psd_pad_to=1, the default
    ladder pads 56 to 64): the same PSD
    buckets as the JAX package's compile_cones and as the port's for the
    CPU, each side routed to the kernel of ``kernel_for`` in float32 and
    float64 (an odd side to none: the reference's eigh branch; 896 fits a
    cluster in float32, not in float64)."""
    sets = {mod: [mod.PsdConeTriangle(side * (side + 1) // 2),
                  mod.PsdConeTriangle(side * (side + 1) // 2)] for mod in (ct, pt)}
    jc = jcd.compile_cones(sets[ct], psd_pad_to=pad, eigh_backend="amortized")
    ref = [(b.gather_idx.shape[0], b.side) for b in jc.psd_buckets]
    for device in ("cuda", "cpu"):
        tc = tcd.compile_cones(sets[pt], psd_pad_to=pad, eigh_backend="amortized",
                               device=device)
        assert tc.eigh_backend == jc.eigh_backend == "amortized"
        assert [(b.batch, b.side) for b in tc.psd_buckets] == ref == [(2, side)]
    assert (JE.kernel_for(side, torch.float32), JE.kernel_for(side, torch.float64)) == kernels


def test_kernel_for_routes_every_side():
    """Even 4..48 to jacobi_eig, 2 and the even sides above 48 to
    jacobi_eig_cluster while W fits a cluster and to jacobi_eig_large past
    that (up to 65,536), odd sides to none, each named kernel with its
    launcher; the launchers refuse CPU tensors and odd sides before any
    build."""
    for dtype in (torch.float32, torch.float64):
        assert [JE.kernel_for(k, dtype)
                for k in (2, 3, 4, 47, 48, 49, 50, 258, 1024, 65536, 65538)] == [
            "jacobi_eig_cluster", None, "jacobi_eig", None, "jacobi_eig", None,
            "jacobi_eig_cluster", "jacobi_eig_cluster", "jacobi_eig_large",
            "jacobi_eig_large", None]
    assert set(JE.LAUNCHERS) == {"jacobi_eig", "jacobi_eig_cluster", "jacobi_eig_large"}
    stale = torch.tensor(True)
    for k in (5, 50):
        W = torch.as_tensor(sym_stack(1, k, seed=k))
        with pytest.raises(ValueError):
            JE.jacobi_eig_cuda(W, W.clone(), 2, 8)
        with pytest.raises(ValueError):
            JE.jacobi_eig_large_cuda(W, W.clone(), stale, 2, 8)
        with pytest.raises(ValueError):
            JE.jacobi_eig_cluster_cuda(W, W.clone(), stale, 2, 8)


def test_full_sweep_tallies_by_kernel_side_and_type():
    """One full-sweep tally for each key of the launch counter (kernel, k,
    dtype name) on each device: read together by key, zeroed by
    reset_counts."""
    big, small = ("jacobi_eig_cluster", 896, "float32"), ("jacobi_eig", 16, "float64")
    JE.reset_counts()
    JE._tally(big, "cpu").add_(3)
    JE._tally(small, "cpu").add_(1)
    JE._tally(big, "cpu").add_(2)
    counts = JE.full_sweep_counts("cpu")
    assert counts[big] == 5 and counts[small] == 1 and sum(counts.values()) == 6
    JE.reset_counts()
    assert set(JE.full_sweep_counts("cpu").values()) == {0}


@pytest.mark.parametrize("k", [2, 50, 56])
@pytest.mark.parametrize("warm", [True, False], ids=["warm", "stale"])
def test_amortized_large_sides_match_reference(k, warm):
    """The port's amortized projection (the plain version on the CPU)
    against the JAX function at the large kernel's sides: the staleness
    rule classes the case as built, and P and V agree within 1e-10 of max
    |X| (V within 1e-10)."""
    X, V = _amortized_case(2, k, warm, seed=10 * k + warm)
    _, _, stale = teigh.amortized_rotate(torch.as_tensor(X), torch.as_tensor(V))
    assert bool(stale) != warm
    jP, jV = _jax_amortized(jnp.asarray(X), jnp.asarray(V), 2, 8)
    tP, tV = JE.psd_project_amortized(torch.as_tensor(X), torch.as_tensor(V), 2, 8)
    _near(tP.numpy(), jP, np.abs(X).max())
    _near(tV.numpy(), jV, 1.0)


class _NoHostRead:
    """A stale flag that fails the test when it is read on the host."""

    def __bool__(self):
        raise AssertionError("the stale flag was read on the host")


def test_odd_side_follows_the_reference_eigh_branch():
    """At k = 5 with a carried basis that is not the identity the
    reference's jacobi_eigh takes eigh(W) and drops V0: the port's
    projection matches the JAX one within 1e-10 of max |X| and equals the
    eigh branch on W = V'XV (P is the projection of W, not of X), V is W's
    eigenbasis, and the branch reads no stale flag (a flag that raises on a
    host read goes through; at an even side it is read)."""
    k = 5
    X, V = _amortized_case(3, k, True, seed=5)
    V = V @ np.linalg.qr(np.eye(k) + 0.3 * sym_stack(3, k, seed=6))[0]
    jP, jV = jeigh.psd_project_amortized(jnp.asarray(X), jnp.asarray(V), 2, 8)
    tP, tV = JE.psd_project_amortized(torch.as_tensor(X), torch.as_tensor(V), 2, 8)
    _near(tP.numpy(), jP, np.abs(X).max())
    W, V0, _ = teigh.amortized_rotate(torch.as_tensor(X), torch.as_tensor(V))
    bP, bV = teigh.jacobi_eig_plain(W, V0, _NoHostRead(), 2, 8)
    assert torch.equal(bP, tP) and torch.equal(bV, tV)
    projection_of_x = teigh.psd_project_eigh(torch.as_tensor(X)).numpy()
    assert np.abs(tP.numpy() - projection_of_x).max() > 1e-3
    _, Q = np.linalg.eigh(W.numpy())
    _near(np.abs(np.einsum("bij,bjk->bik", Q.swapaxes(1, 2), tV.numpy())),
          np.broadcast_to(np.eye(k), (3, k, k)), 1.0, tol=1e-8)
    W6 = torch.as_tensor(sym_stack(1, 6, seed=6))
    with pytest.raises(AssertionError, match="read on the host"):
        teigh.jacobi_eig_plain(W6, torch.eye(6, dtype=W6.dtype)[None], _NoHostRead(), 2, 8)


@pytest.mark.parametrize("k", [258, 896])
def test_uint16_pair_table_is_the_round_robin_schedule(k):
    """The large kernel's uint16 table lists _round_robin_rounds(k) round by
    round, p then q, at sides past the uint8 table's 256."""
    table = J.pair_schedule(k, np.uint16)
    assert table.dtype == np.uint16 and table.shape == ((k - 1) * k,)
    want = np.stack([np.stack(pq, axis=1) for pq in teigh._round_robin_rounds(k)])
    np.testing.assert_array_equal(table.reshape(k - 1, k // 2, 2), want)
    assert JE._schedule_on(k, torch.device("cpu"), np.uint16).numpy().view(
        np.uint16).tolist() == table.tolist()


def test_uint8_pair_table_refuses_past_side_256():
    """pair_schedule's uint8 table ends at k = 256: a larger side raises a
    ValueError that names the limit, not numpy's OverflowError."""
    assert J.pair_schedule(256).max() == 255
    with pytest.raises(ValueError, match="k <= 256"):
        J.pair_schedule(258)


def tile_rounds(W, V0, sweeps):
    """The round scheme of csrc/jacobi_eig_large.cu in torch, tile by tile
    as the kernel's threads compute them: round t reads W from the input
    (t = 0) or from scratch buffer (t - 1) % 2 and writes buffer t % 2; tile
    (i, j) computes both angles from what it reads, then its rows, then its
    columns; V's rows p_i, q_i turn at the columns p_j, q_j in place; a
    sweep's first round after the first reads 0.5 (W[a,b] + W[b,a]). Returns
    (diag W, V)."""
    B, k, _ = W.shape
    h = k // 2
    table = torch.as_tensor(J.pair_schedule(k, np.uint16).astype(np.int64)).view(
        k - 1, h, 2)
    bufs = (torch.empty_like(W), torch.empty_like(W))
    src, vin, V = W, V0, torch.empty_like(V0)
    for t in range(sweeps * (k - 1)):
        r = t % (k - 1)
        sym = t > 0 and r == 0

        def entry(a, b):
            x = src[:, a, b]
            return 0.5 * (x + src[:, b, a]) if sym else x

        p, q = table[r, :, 0], table[r, :, 1]
        c, s = teigh.rotation_angles(entry(p, p), entry(q, q), entry(p, q))
        ci, si, cj, sj = c[:, :, None], s[:, :, None], c[:, None, :], s[:, None, :]
        Pi, Qi, Pj, Qj = p[:, None], q[:, None], p[None, :], q[None, :]
        xpp, xpq, xqp, xqq = entry(Pi, Pj), entry(Pi, Qj), entry(Qi, Pj), entry(Qi, Qj)
        rpp, rpq = ci * xpp - si * xqp, ci * xpq - si * xqq
        rqp, rqq = si * xpp + ci * xqp, si * xpq + ci * xqq
        dst = bufs[t % 2]
        dst[:, Pi, Pj], dst[:, Pi, Qj] = cj * rpp - sj * rpq, sj * rpp + cj * rpq
        dst[:, Qi, Pj], dst[:, Qi, Qj] = cj * rqp - sj * rqq, sj * rqp + cj * rqq
        turned = [(row, cj * vin[:, row, Pj] - sj * vin[:, row, Qj],
                   sj * vin[:, row, Pj] + cj * vin[:, row, Qj]) for row in (Pi, Qi)]
        for row, vp, vq in turned:
            V[:, row, Pj], V[:, row, Qj] = vp, vq
        src, vin = dst, V
    if sweeps == 0:
        V = V0.clone()
    return torch.diagonal(src, dim1=-2, dim2=-1), V


@pytest.mark.parametrize("k,sweeps", [(2, 3), (50, 2), (56, 3), (10, 0)])
def test_large_kernel_round_scheme_is_the_plain_version(k, sweeps):
    """The large kernel's round scheme (tile_rounds) gives the bits of the
    plain version's jacobi_eigh from a warm basis: the ping-pong buffers,
    the per-tile angles and the folded symmetrisation reorder no operation
    (on the card only the kernel's FMAs and its Newton-refined reciprocals
    round otherwise)."""
    X, V = _amortized_case(3, k, True, seed=k)
    W, V0, _ = teigh.amortized_rotate(torch.as_tensor(X), torch.as_tensor(V))
    w, Q = tile_rounds(W, V0, sweeps)
    w_ref, Q_ref = teigh.jacobi_eigh(W, sweeps, V0=V0)
    assert torch.equal(w, w_ref) and torch.equal(Q, Q_ref)


def test_amortized_solve_with_a_side56_bucket_matches_reference():
    """block_sdp(1, 56, 12) with eigh_backend="amortized" and psd_pad_to=1
    (one [1, 56] bucket: the large kernel's side on the card) in both
    packages at eps 1e-5: the same status, the objective within 1e-6
    relative and x within 1e-6 (iterations not compared)."""
    def run(mod):
        P, q, A, b, sets = (jprob if mod is ct else tprob).block_sdp(
            n_blocks=1, side=56, n=12, seed=5)
        s = mod.Settings(eps_abs=1e-5, eps_rel=1e-5, eigh_backend="amortized",
                         psd_pad_to=1)
        model = mod.Model(s) if mod is ct else mod.Model(s, device="cpu")
        model.set(P, q, A, b, sets)
        return model, model.optimize()

    mt, rt = run(pt)
    _, rj = run(ct)
    assert [(b.batch, b.side) for b in mt._dev_cache["cones"].psd_buckets] == [(1, 56)]
    assert rj.status == rt.status == "Solved"
    assert abs(rt.obj_val - rj.obj_val) <= 1e-6 * abs(rj.obj_val)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)
