"""The amortized backend's grid kernel (csrc/jacobi_eig_grid.cu) on the CPU:
its schedule emulated in numpy against the plain version bit for bit; the
G1-shaped maxcut problem of chip_smoke.py's phase 10i and a small amortized
maxcut held to cosmo_tpu; and the kernel against its plain version on the
card (skips here).

The kernel runs only on the card (chip_smoke.py 10e, 10h, 10i). Here
``grid_run`` does what its CTAs do, each CTA a generator run by a scheduler
that resumes it only when the flags it waits on allow: slot ownership by
CTA range (the geometry of csrc/jacobi_circle.cuh), each CTA's columns as
two rings with a spare column, the tiles turned in place; through "global
memory" the mailboxes (each column's diagonal entry and its entry at its
next partner's row), the leaving columns in the neighbours' inboxes, both
double-buffered by the round's parity, and the row-major copy of W that
the symmetrisation reads at a sweep's start; per-CTA round flags, every
CTA's angles from the mailboxes, the owners' angle log, and V replayed from
the log on each CTA's rows, a round once a wait has seen every CTA log it
(the kernel's replay warps follow its W phase so). Every read of global
memory checks the round
its entry was written for, so a schedule in which a buffer is overwritten
before every reader has read it fails. The angles come from
``eigh.rotation_angles`` by callback (the plain version's own), the tile and
replay arithmetic from numpy's correctly rounded products and sums."""
import numpy as np
import pytest
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob
from cosmo_tpu_torch.ops import eigh as teigh
from cosmo_tpu_torch.ops import jacobi_eig as JE

from _torch_port import sym_stack

torch.set_num_threads(1)


def _label_at(x, r, k):
    """players[x] of _round_robin_rounds(k) after r shifts (x may be an
    array)."""
    x = np.asarray(x)
    return np.where(x == 0, 0, 1 + (x - 1 - r) % (k - 1))


def _position_of(a, r, k):
    return 0 if a == 0 else 1 + (a - 1 + r) % (k - 1)


def _ring(j, t, n):
    """The ring column of arc position j in round t (a ring of n + 1)."""
    return (j - t) % (n + 1)


class _Grid:
    """The kernel's layout of one matrix over G CTAs (jacobi_circle.cuh)."""

    def __init__(self, k, G):
        self.k, self.G, self.h = k, G, k // 2
        self.M = -(-self.h // G)

    def arcs(self, g):
        lo, hi = g * self.h // self.G, (g + 1) * self.h // self.G
        top0 = max(lo, 1)
        return lo, hi, top0, hi - top0, hi - lo

    def plan(self, g, s, t):
        """Slot s's columns (top, bottom) in round t, where a column that
        leaves its arc goes (CTA, column), its labels and each label's
        partner in round t + 1 (plan_slot)."""
        k, h, G, M = self.k, self.h, self.G, self.M
        lo, hi, top0, lt, lb = self.arcs(g)
        r, rn = t % (k - 1), (t + 1) % (k - 1)
        label = (int(_label_at(s, r, k)), int(_label_at(k - 1 - s, r, k)))
        col = (M if s == 0 else _ring(s - top0, t, lt), M + 1 + _ring(hi - 1 - s, t, lb))
        dst = [(g, col[0]), (g, col[1])]
        if s >= 1 and s == hi - 1:
            d = g + 1 if g < G - 1 else g
            _, _, _, blt, blb = self.arcs(d)
            dst[0] = (d, _ring(blt, t, blt) if g < G - 1 else M + 1 + _ring(blb, t, blb))
        if s == lo:
            if g > 0:
                blb = self.arcs(g - 1)[4]
                dst[1] = (g - 1, M + 1 + _ring(blb, t, blb))
            elif lt > 0 or G > 1:
                d = 0 if lt > 0 else 1
                blt = self.arcs(d)[3]
                dst[1] = (d, _ring(blt, t, blt))
            else:
                dst[1] = (g, M + 1 + _ring(lb, t, lb))
        nxt = [int(_label_at(k - 1 - _position_of(label[e], rn, k), rn, k)) for e in range(2)]
        return dict(label=label, col=col, dst=dst, next=nxt)


def _turn(colp, colq, dp, dq, pi, qi, ci, si, cj, sj):
    """The tiles {p_i, q_i} x {p_j, q_j} of every pair i: rows, then the
    columns p_j, q_j (turn_tile), from colp, colq into dp, dq."""
    xpp, xqp, xpq, xqq = colp[pi], colp[qi], colq[pi], colq[qi]
    rpp, rpq = ci * xpp - si * xqp, ci * xpq - si * xqq
    rqp, rqq = si * xpp + ci * xqp, si * xpq + ci * xqq
    dp[pi], dq[pi] = cj * rpp - sj * rpq, sj * rpp + cj * rpq
    dp[qi], dq[qi] = cj * rqp - sj * rqq, sj * rqp + cj * rqq


def grid_run(W, V0, stale, warm, full, G, schedule, seed=0):
    """The grid kernel's schedule in numpy for G CTAs a matrix, the CTAs
    interleaved by ``schedule`` ("random": a runnable CTA drawn at each
    step; "ahead": always the lowest-numbered runnable one, which runs as
    far ahead as the flags let it). Returns (d, V, trace): ``trace`` counts
    the columns each CTA sent and received through the inboxes, the
    mailbox entries written, and records the CTAs whose data each CTA read
    after each wait beside the flags it waited on."""
    B, k, _ = W.shape
    dt = W.dtype.type
    geo = _Grid(k, G)
    h, M = geo.h, geo.M
    rounds = (full if stale else warm) * (k - 1)
    half = dt(0.5)
    # global memory, each entry tagged with (matrix, round) it holds
    mail = np.full((2, h, 2, 2), np.nan, W.dtype)
    mail_tag = np.full((2, h, 2), -1, np.int64)
    inbox = np.full((2, G, 2, k), np.nan, W.dtype)
    inbox_tag = np.full((2, G, 2), -1, np.int64)
    dump = np.full((k, k), np.nan, W.dtype)
    dump_tag = np.full(k, -1, np.int64)
    alog = np.full((max(rounds, 1), h, 2), np.nan, W.dtype)
    alog_tag = np.full((max(rounds, 1), h), -1, np.int64)
    flags = np.zeros(G, np.int64)
    d = np.full((B, k), np.nan, W.dtype)
    V = np.full_like(V0, np.nan)
    trace = dict(sent=np.zeros(G, np.int64), received=np.zeros(G, np.int64),
                 mail_entries=np.zeros(G, np.int64), read_from=[], waited_on=[])

    def tag(b, t):
        return b * (rounds + 2) + t

    def angles_of(app, aqq, apq):
        c, s = teigh.rotation_angles(torch.from_numpy(app), torch.from_numpy(aqq),
                                     torch.from_numpy(apq))
        return c.numpy(), s.numpy()

    def cta(g):
        lo, hi, top0, lt, lb = geo.arcs(g)
        m = lb
        cols = np.full((2 * (M + 1), k), np.nan, W.dtype)
        i_all = np.arange(h)
        seq = 0

        def columns_in(b, t):
            # tops from CTA g - 1, bottoms from CTA g + 1, into the entry
            # ends of the arcs
            read = set()
            for arc, src, at in ((0, g - 1, _ring(0, t, lt)),
                                 (1, g + 1, M + 1 + _ring(0, t, lb))):
                if 0 <= src < G:
                    assert inbox_tag[t & 1, g, arc] == tag(b, t), (g, t, arc)
                    cols[at] = inbox[t & 1, g, arc]
                    trace["received"][g] += 1
                    read.add(src)
            return read

        for b in range(B):
            # V: this CTA's rows of V0, turned by each logged round as soon as
            # a wait has seen every CTA log it (the replay's warps)
            r0, r1 = g * k // G, (g + 1) * k // G
            rows = V0[b, r0:r1].copy()
            done = [0]

            def replay(logged):
                for u in range(done[0], logged):
                    assert (alog_tag[u] == b).all(), (g, u)
                    r = u % (k - 1)
                    x0, x1 = _label_at(i_all, r, k), _label_at(k - 1 - i_all, r, k)
                    p_lab, q_lab = np.minimum(x0, x1), np.maximum(x0, x1)
                    cc, ss = alog[u, :, 0], alog[u, :, 1]
                    vp, vq = rows[:, p_lab], rows[:, q_lab]
                    rows[:, p_lab], rows[:, q_lab] = cc * vp - ss * vq, ss * vp + cc * vq
                done[0] = max(done[0], logged)

            plans = [geo.plan(g, s, 0) for s in range(lo, hi)]
            for p in plans:
                for e in range(2):
                    cols[p["col"][e]] = W[b, :, p["label"][e]]
            for t in range(rounds):
                r = t % (k - 1)
                sym = t > 0 and r == 0
                plans = [geo.plan(g, s, t) for s in range(lo, hi)]
                read = set()
                if t > 0:
                    yield seq + t
                    trace["waited_on"].append(set(range(G)))
                    read |= columns_in(b, t)
                    replay(t)
                # every CTA all k/2 angles, from W in round 0, else from the
                # mailboxes of the round before
                x0, x1 = _label_at(i_all, r, k), _label_at(k - 1 - i_all, r, k)
                P = x0 > x1
                p_lab, q_lab = np.minimum(x0, x1), np.maximum(x0, x1)
                if t == 0:
                    app, aqp = W[b, p_lab, p_lab], W[b, q_lab, p_lab]
                    aqq, apq = W[b, q_lab, q_lab], W[b, p_lab, q_lab]
                else:
                    got = []
                    for pos in (i_all, k - 1 - i_all):
                        back = np.where(pos == 0, 0, np.where(pos == 1, k - 1, pos - 1))
                        top = back < h
                        slot = np.where(top, back, k - 1 - back)
                        side = np.where(top, 0, 1)
                        assert (mail_tag[t & 1, slot, side] == tag(b, t)).all(), (g, t)
                        read |= {geo_owner for geo_owner in
                                 (((slot + 1) * G + h - 1) // h - 1).tolist()}
                        got.append(mail[t & 1, slot, side])
                    bp = np.where(P[:, None], got[1], got[0])
                    bq = np.where(P[:, None], got[0], got[1])
                    app, aqp, aqq, apq = bp[:, 0], bp[:, 1], bq[:, 0], bq[:, 1]
                if t > 0:
                    trace["read_from"].append(read)
                if sym:
                    app, aqq, apq = half * (app + app), half * (aqq + aqq), half * (apq + aqp)
                c, s = angles_of(np.ascontiguousarray(app), np.ascontiguousarray(aqq),
                                 np.ascontiguousarray(apq))
                alog[t, lo:hi, 0], alog[t, lo:hi, 1] = c[lo:hi], s[lo:hi]
                alog_tag[t, lo:hi] = b
                if sym:
                    # column b's row a from row b of the copy of W
                    assert (dump_tag == tag(b, t)).all()
                    for p in plans:
                        for e in range(2):
                            col = cols[p["col"][e]]
                            col[:] = half * (col + dump[p["label"][e]])
                # the mailbox of round t + 1 from the round-start columns
                # (computed here as the turned columns' entries: peek_tile's
                # operations are turn_tile's)
                turned = {}
                for n, p in enumerate(plans):
                    j = lo + n
                    Pj = 0 if p["label"][0] < p["label"][1] else 1
                    cp_, cq_ = cols[p["col"][Pj]].copy(), cols[p["col"][1 - Pj]].copy()
                    dp, dq = cp_.copy(), cq_.copy()
                    _turn(cp_, cq_, dp, dq, p_lab, q_lab, c, s, c[j], s[j])
                    turned[n] = (dp, dq) if Pj == 0 else (dq, dp)
                out_tag = tag(b, t + 1)
                for n, p in enumerate(plans):
                    for e in range(2):
                        col = turned[n][e]
                        mail[(t + 1) & 1, lo + n, e] = (col[p["label"][e]],
                                                        col[p["next"][e]])
                        mail_tag[(t + 1) & 1, lo + n, e] = out_tag
                        trace["mail_entries"][g] += 2
                # the tiles of the slots whose columns leave their arcs, then
                # the leaving columns into the other CTAs' inboxes ...
                exits = sorted({0, m - 1})
                for n in exits:
                    p = plans[n]
                    for e in range(2):
                        at = p["dst"][e][1] if p["dst"][e][0] == g else p["col"][e]
                        cols[at] = turned[n][e]
                for side, n in ((0, m - 1), (1, 0)):
                    p = plans[n]
                    dst_g, dst_col = p["dst"][side]
                    if dst_g != g:
                        arc = 0 if dst_col <= M else 1
                        inbox[(t + 1) & 1, dst_g, arc] = cols[p["col"][side]]
                        inbox_tag[(t + 1) & 1, dst_g, arc] = out_tag
                        trace["sent"][g] += 1
                sweep_end = (t + 1) % (k - 1) == 0 and t + 1 < rounds
                if not sweep_end:
                    flags[g] = seq + t + 1
                    yield None
                # ... then the other slots' tiles, in place
                for n in range(1, m - 1):
                    p = plans[n]
                    for e in range(2):
                        cols[p["col"][e]] = turned[n][e]
                if sweep_end:
                    for n, p in enumerate(plans):
                        for e in range(2):
                            at = p["dst"][e][1] if p["dst"][e][0] == g else p["col"][e]
                            dump[:, p["label"][e]] = cols[at]
                            dump_tag[p["label"][e]] = tag(b, t + 1)
                    flags[g] = seq + t + 1
                    yield None
            if rounds > 0:
                yield seq + rounds
                columns_in(b, rounds)
            plans = [geo.plan(g, s, rounds) for s in range(lo, hi)]
            for p in plans:
                for e in range(2):
                    x = cols[p["col"][e], p["label"][e]]
                    d[b, p["label"][e]] = half * (x + x) if rounds > 0 else x
            replay(rounds)
            V[b, r0:r1] = rows
            seq += rounds + 1
            if b + 1 < B:
                flags[g] = seq
                yield seq

    rng = np.random.default_rng(seed)
    waiting = {g: 0 for g in range(G)}
    live = {g: cta(g) for g in range(G)}
    while live:
        runnable = [g for g in live if (flags >= waiting[g]).all()]
        assert runnable, "the CTAs wait on each other"
        g = runnable[0] if schedule == "ahead" else runnable[rng.integers(len(runnable))]
        try:
            target = next(live[g])
            waiting[g] = 0 if target is None else target
        except StopIteration:
            del live[g]
    return d, V, trace


def _case(B, k, warm, dtype, seed):
    """(W, V0, stale) of one projection after the torch rotation: X a
    symmetric Gaussian stack; warm, V_prev X's eigenbasis turned by an
    orthogonal matrix near I; stale, V_prev = I."""
    rng = np.random.default_rng(seed)
    X = sym_stack(B, k, seed)
    if warm:
        R = rng.standard_normal((B, k, k)) * 0.01 * min(1.0, np.sqrt(48 / k))
        R, _ = np.linalg.qr(np.eye(k) + (R - R.swapaxes(1, 2)))
        V_prev = np.linalg.eigh(X)[1] @ R
    else:
        V_prev = np.broadcast_to(np.eye(k), (B, k, k)).copy()
    W, V0, stale = teigh.amortized_rotate(torch.as_tensor(X, dtype=dtype),
                                          torch.as_tensor(V_prev, dtype=dtype))
    assert bool(stale) != warm
    return W.contiguous(), V0.contiguous(), stale


_SCHEME_CASES = [(k, JE.grid_ctas(k), warm, torch.float64, "random")
                 for k in (50, 64, 96) for warm in (True, False)]
_SCHEME_CASES += [(64, 5, True, torch.float32, "ahead"), (96, 7, False, torch.float32, "ahead"),
                  (50, 3, False, torch.float64, "ahead"), (96, 11, True, torch.float64, "random")]


@pytest.mark.parametrize("k,G,warm,dtype,schedule", _SCHEME_CASES)
def test_grid_schedule_is_the_plain_version(k, G, warm, dtype, schedule):
    """The grid kernel's schedule (grid_run) gives jacobi_eig_plain's bits,
    d and V, warm (2 sweeps) and stale (8 sweeps), at the kernel's CTA
    count (grid_ctas: one slot a CTA here) and at counts that leave the
    CTAs uneven slot ranges, with the CTAs interleaved at random or run as
    far ahead as the flags let them; every column that leaves a CTA is
    received once, every CTA but the ends receives one column from each
    side a round, and every read after a wait is of CTAs the wait
    covered."""
    W, V0, stale = _case(1, k, warm, dtype, seed=k + G)
    d, V, trace = grid_run(W.numpy(), V0.numpy(), bool(stale), 2, 8, G, schedule, seed=k)
    w_ref, V_ref = teigh.jacobi_eigh(W, 8 if bool(stale) else 2, V0=V0)
    assert np.array_equal(d, w_ref.numpy()) and np.array_equal(V, V_ref.numpy())
    rounds = (8 if bool(stale) else 2) * (k - 1)
    assert trace["sent"].sum() == trace["received"].sum()
    ends = (G - 1) if G > 1 else 0
    assert trace["received"].sum() == rounds * 2 * ends
    assert (trace["mail_entries"] == 4 * rounds * np.diff(
        [g * (k // 2) // G for g in range(G + 1)])).all()
    assert all(r <= w for r, w in zip(trace["read_from"], trace["waited_on"]))


def test_grid_schedule_walks_a_stack():
    """B = 2 through one grid: the second matrix waits for every CTA to end
    the first (the log and the buffers are reused); both give the plain
    version's bits (float64, stale: the staleness rule classes the stack
    at once)."""
    W, V0, stale = _case(2, 50, False, torch.float64, seed=3)
    d, V, _ = grid_run(W.numpy(), V0.numpy(), bool(stale), 2, 8, 25, "ahead")
    w_ref, V_ref = teigh.jacobi_eigh(W, 8, V0=V0)
    assert np.array_equal(d, w_ref.numpy()) and np.array_equal(V, V_ref.numpy())


def test_grid_route_and_bytes():
    """kernel_for sends the G1 path's [1, 768] float64 bucket and 10h's
    [1, 640] to jacobi_eig_grid, on 128 CTAs; a CTA's shared memory at 768
    (3 slots and 6 rows of V each) is 95,600 bytes, and the grid holds
    float64 W to k = 1,232, float32 to 1,792."""
    assert JE.kernel_for(768, torch.float64) == JE.kernel_for(640, torch.float64) == (
        "jacobi_eig_grid")
    assert JE.grid_ctas(768) == 128 and JE.grid_ctas(100) == 50
    assert JE.grid_smem_bytes(768, 128, 8) == (2 * 4 * 768 * 8 + 6 * 768 * 8 + 768 * 8
                                               + 8 * 384 + 240 + 96 + 32)
    for dtype, last in ((torch.float64, 1232), (torch.float32, 1792)):
        assert JE.grid_kernel_takes(last, dtype) and not JE.grid_kernel_takes(last + 2, dtype)
        assert JE.kernel_for(last + 2, dtype) == "jacobi_eig_large"
    W = torch.zeros(1, 768, 768, dtype=torch.float64)
    with pytest.raises(ValueError):
        JE.jacobi_eig_grid_cuda(W, W.clone(), torch.tensor(True), 2, 8)


def test_g1_maxcut_laplacian_is_the_reference():
    """problems.maxcut(800, 0.06, seed=0), chip_smoke.py's phase 10i: the
    same L, b and q as cosmo_tpu.problems.maxcut, bit for bit (19,267
    edges; G1 of the G set has 800 nodes and 19,176)."""
    ref = jprob.maxcut(800, 0.06, seed=0)
    got = tprob.maxcut(800, 0.06, seed=0)
    for name, i in (("q", 1), ("b", 3), ("L", 5)):
        assert got[i].dtype == ref[i].dtype and np.array_equal(got[i], ref[i]), name
    assert int((np.triu(got[5], 1) != 0).sum()) == 19267
    assert [type(s).__name__ for s in got[4]] == [type(s).__name__ for s in ref[4]]


def test_small_amortized_maxcut_matches_reference():
    """maxcut(60, 0.3) in float64 with eigh_backend="amortized" at the
    default decomposition and eps 1e-5 in both packages: the same status,
    the objective within 1e-6 relative, x and y within 1e-5 of max |x|,
    max |y| (iterations not compared)."""
    import scipy.sparse as sp

    def run(mod, prob):
        P, q, A, b, sets, _ = prob.maxcut(60, 0.3, seed=0)
        s = mod.Settings(eps_abs=1e-5, eps_rel=1e-5, eigh_backend="amortized",
                         dtype=np.float64)
        model = mod.Model(s) if mod is ct else mod.Model(s, device="cpu")
        model.set(P, q, sp.csr_matrix(A), b, sets)
        return model.optimize()

    rt, rj = run(pt, tprob), run(ct, jprob)
    assert rj.status == rt.status == "Solved"
    assert abs(rt.obj_val - rj.obj_val) <= 1e-6 * abs(rj.obj_val)
    for a in ("x", "y"):
        ref = np.asarray(getattr(rj, a))
        np.testing.assert_allclose(getattr(rt, a), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_grid_kernel_is_the_plain_version_on_card(cuda, dtype):
    """jacobi_eig_grid through its launcher against jacobi_eig_plain on the
    card, to the bit: k 50, 64, 96 (B 1 and 2) and the 10h and 10i sides
    640, 768 (B 1), warm and stale, at the default CTA count and at 7 (uneven
    slot ranges); the full-sweep tally one a stale launch; the kernel's
    shared memory as grid_smem_bytes says."""
    from cosmo_tpu_torch.ops import cuda_build

    lib = cuda_build.jacobi_library()
    t = "f32" if dtype == torch.float32 else "f64"
    n_full = torch.zeros(1, dtype=torch.int32, device=cuda)
    n_stale = 0
    for k, batches in ((50, (1, 2)), (64, (1, 2)), (96, (1, 2)), (640, (1,)), (768, (1,))):
        ctas = JE.grid_ctas(k)
        assert getattr(lib, f"jacobi_eig_grid_smem_{t}")(k, ctas) == (
            JE.grid_smem_bytes(k, ctas, dtype.itemsize))
        for B in batches:
            for warm in (True, False):
                W, V0, stale = (x.to(cuda) for x in _case(B, k, warm, dtype, seed=k + B))
                n_stale += not warm
                ref = JE.jacobi_eig_plain(W, V0, stale, 2, 8)
                for ctas in (None, 7):
                    got = JE.jacobi_eig_grid_cuda(W, V0, stale, 2, 8,
                                                  n_full if ctas is None else None, ctas)
                    torch.cuda.synchronize()
                    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (
                        k, B, warm, ctas)
    assert n_full.item() == n_stale


_FAULT_SCRIPT = """
import sys
import torch
from cosmo_tpu_torch.ops import cuda_build
from cosmo_tpu_torch.ops import jacobi_eig as JE

k = 640
X = torch.randn(1, k, k, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
W = ((X + X.mT) / 2).contiguous().cuda()
V0 = torch.eye(k, dtype=torch.float64).expand(1, k, k).contiguous().cuda()
stale = torch.tensor(True, device="cuda")
lib = cuda_build.variant_library("jacobi_eig_grid.cu", "-DJACOBI_GRID_WAIT_NS=0")
try:
    w, V = JE.launch_grid(lib, W, V0, stale, 2, 8, None, JE.grid_ctas(k))
    torch.cuda.synchronize()
except RuntimeError as err:
    print("raised:", err)
    sys.exit(0)
print("returned", bool(torch.isfinite(w).all()))
sys.exit(1)
"""


@pytest.mark.cuda
def test_grid_kernel_fault_raises_on_card(cuda):
    """A wait that gives up ends the launch with an error, never with
    outputs: the kernel built with a zero wait limit (it gives up at the
    first wait that finds a CTA's flag behind, which a [1, 640] stale
    launch's 5,112 rounds cannot all avoid) makes the stream's next
    synchronisation raise. In a process of its own: the fault ends its
    CUDA context."""
    import subprocess
    import sys
    from pathlib import Path

    run = subprocess.run([sys.executable, "-c", _FAULT_SCRIPT],
                         cwd=Path(__file__).resolve().parent.parent,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "raised:" in run.stdout, run.stdout + run.stderr
