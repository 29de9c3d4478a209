"""The amortized backend's cluster kernel (csrc/jacobi_eig_cluster.cu) on the
CPU: its scheme emulated in torch against the plain version bit for bit,
and the rule that routes a side to it.

The kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py
10e-10g). Here ``cluster_rounds`` does what its CTAs do, column for column:
slot ownership by CTA range, the two arcs of each CTA as rings with a spare
column, the tiles turned in place, the circle shift with the boundary
columns copied into the next arc's spare, each CTA's mailbox (each of its
columns' diagonal entry and entry at its next partner's row), every CTA's
angles computed from the mailboxes (each label's column found one round
back on the circle), the owners' angle log, the symmetrisation in place
between sweeps, and V replayed from the log. It must give
``eigh.jacobi_eigh``'s bits (the plain version's Jacobi from V0) at every
sweep count."""
import numpy as np
import pytest
import torch

from cosmo_tpu_torch.ops import eigh as teigh
from cosmo_tpu_torch.ops import jacobi_eig as JE

from _torch_port import sym_stack

torch.set_num_threads(1)


def _label_at(x, r, k):
    """players[x] of _round_robin_rounds(k) after r shifts."""
    return 0 if x == 0 else 1 + (x - 1 - r) % (k - 1)


def _position_of(a, r, k):
    return 0 if a == 0 else 1 + (a - 1 + r) % (k - 1)


def _ring(j, t, n):
    """The ring column of arc position j in round t (a ring of n + 1)."""
    return (j - t) % (n + 1)


class _Geometry:
    """The kernel's layout of one matrix over a cluster of C CTAs."""

    def __init__(self, k, C):
        self.k, self.C, self.h = k, C, k // 2
        self.M = -(-self.h // C)
        self.ncol = 2 * (self.M + 1)

    def arcs(self, rank):
        lo, hi = rank * self.h // self.C, (rank + 1) * self.h // self.C
        top0 = max(lo, 1)
        return lo, hi, top0, hi - top0, hi - lo

    def owner(self, s):
        return ((s + 1) * self.C + self.h - 1) // self.h - 1

    def locate(self, label, t):
        """(rank, column) of column ``label`` in round t."""
        k, h, M = self.k, self.h, self.M
        x = _position_of(label, t % (k - 1), k)
        if x == 0:
            return 0, M
        s = x if x < h else k - 1 - x
        rank = self.owner(s)
        lo, hi, top0, lt, lb = self.arcs(rank)
        return rank, (_ring(s - top0, t, lt) if x < h else M + 1 + _ring(hi - 1 - s, t, lb))

    def plan(self, rank, s, t):
        """Slot s's columns (top, bottom) in round t, where a column that
        leaves its arc goes, their labels and each label's partner in round
        t + 1 (the kernel's plan_slot)."""
        k, h, C, M = self.k, self.h, self.C, self.M
        lo, hi, top0, lt, lb = self.arcs(rank)
        r, rn = t % (k - 1), (t + 1) % (k - 1)
        label = (_label_at(s, r, k), _label_at(k - 1 - s, r, k))
        col = (M if s == 0 else _ring(s - top0, t, lt), M + 1 + _ring(hi - 1 - s, t, lb))
        dst = [(rank, col[0]), (rank, col[1])]
        if s >= 1 and s == hi - 1:
            d = rank + 1 if rank < C - 1 else rank
            _, _, _, blt, blb = self.arcs(d)
            dst[0] = (d, _ring(blt, t, blt) if rank < C - 1 else M + 1 + _ring(blb, t, blb))
        if s == lo:
            if rank > 0:
                blb = self.arcs(rank - 1)[4]
                dst[1] = (rank - 1, M + 1 + _ring(blb, t, blb))
            elif lt > 0 or C > 1:
                d = 0 if lt > 0 else 1
                blt = self.arcs(d)[3]
                dst[1] = (d, _ring(blt, t, blt))
            else:
                dst[1] = (rank, M + 1 + _ring(lb, t, lb))
        nxt = [_label_at(k - 1 - _position_of(label[e], rn, k), rn, k) for e in range(2)]
        return dict(label=label, col=col, dst=dst, next=nxt)

    def slot_plans(self, t):
        """Every slot's plan in round t, by its owner, in slot order."""
        out = []
        for rank in range(self.C):
            lo, hi = self.arcs(rank)[:2]
            out += [(rank, self.plan(rank, s, t)) for s in range(lo, hi)]
        return out


def cluster_rounds(W, V0, sweeps, C):
    """The cluster kernel's scheme in torch for a cluster of C CTAs.
    Returns [(d, V) after 0, 1, ..., ``sweeps`` sweeps]."""
    B, k, _ = W.shape
    g = _Geometry(k, C)
    h, ncol = g.h, g.ncol
    S = W.new_zeros(B, C * ncol, k)  # column (rank, c) at rank * ncol + c

    def index(rank_col):
        return rank_col[0] * ncol + rank_col[1]

    for rank, p in g.slot_plans(0):
        for e in range(2):
            S[:, index((rank, p["col"][e]))] = W[:, :, p["label"][e]]
    mail = None  # [B, C M, side, 2]: each column's diagonal entry and its
    # entry at its next partner's row, by owner, local slot and side
    # each pair's two circle positions, and where the columns there wrote
    # their mailbox entries the round before (the same every round)
    positions = [list(range(h)), [k - 1 - i for i in range(h)]]
    box = []
    for e in range(2):
        idx = []
        for pos in positions[e]:
            back = 0 if pos == 0 else (k - 1 if pos == 1 else pos - 1)
            top = back < h
            sb = back if top else k - 1 - back
            owner = g.owner(sb)
            idx.append(2 * (owner * g.M + sb - g.arcs(owner)[0]) + (0 if top else 1))
        box.append(torch.tensor(idx))
    rounds = sweeps * (k - 1)
    log = W.new_empty(B, rounds, h, 2)
    out = []

    def snapshot(t):
        d = W.new_empty(B, k)
        for rank, p in g.slot_plans(t):
            for e in range(2):
                x = S[:, index((rank, p["col"][e])), p["label"][e]]
                d[:, p["label"][e]] = 0.5 * (x + x) if t > 0 else x
        V = V0.clone()
        for u in range(t):
            r = u % (k - 1)
            x0 = torch.tensor([_label_at(j, r, k) for j in range(h)])
            x1 = torch.tensor([_label_at(k - 1 - j, r, k) for j in range(h)])
            p, q = torch.minimum(x0, x1), torch.maximum(x0, x1)
            c, s = log[:, u, None, :, 0], log[:, u, None, :, 1]
            Vp, Vq = V[:, :, p], V[:, :, q]
            V[:, :, p] = c * Vp - s * Vq
            V[:, :, q] = s * Vp + c * Vq
        out.append((d, V))

    snapshot(0)
    for t in range(rounds):
        r = t % (k - 1)
        sym = t > 0 and r == 0
        plans = g.slot_plans(t)
        if sym:
            # in place: the owner of column b takes (a, b) for a < b, reading
            # W[b, a] from column a's CTA and writing the mean to both
            own, other, diag = [], [], []
            for rank, p in plans:
                for e in range(2):
                    b = p["label"][e]
                    cb = index((rank, p["col"][e]))
                    diag.append((cb, b))
                    for a in range(b):
                        own.append((cb, a))
                        other.append((index(g.locate(a, t)), b))
            own, other, diag = (torch.tensor(x) for x in (own, other, diag))
            x, y = S[:, own[:, 0], own[:, 1]], S[:, other[:, 0], other[:, 1]]
            xd = S[:, diag[:, 0], diag[:, 1]]
            v = 0.5 * (x + y)
            S[:, own[:, 0], own[:, 1]] = v
            S[:, other[:, 0], other[:, 1]] = v
            S[:, diag[:, 0], diag[:, 1]] = 0.5 * (xd + xd)
        # a_pp, a_qp, a_qq, a_pq of every slot: from W in round 0, else from
        # the mailboxes, each label's column found one round back
        lab = torch.tensor([[_label_at(pos, r, k) for pos in positions[e]]
                            for e in range(2)])
        if t == 0:
            x = [(W[:, lab[e], lab[e]], W[:, lab[1 - e], lab[e]]) for e in range(2)]
        else:
            flat = mail.reshape(B, -1, 2)
            x = [(flat[:, box[e], 0], flat[:, box[e], 1]) for e in range(2)]
        P = lab[0] > lab[1]
        app = torch.where(P, x[1][0], x[0][0])
        aqp = torch.where(P, x[1][1], x[0][1])
        aqq = torch.where(P, x[0][0], x[1][0])
        apq = torch.where(P, x[0][1], x[1][1])
        if sym:
            app, aqq, apq = 0.5 * (app + app), 0.5 * (aqq + aqq), 0.5 * (apq + aqp)
        # every CTA computes all k/2 angles; slot s's owner logs its own
        c, s = teigh.rotation_angles(app, aqq, apq)
        log[:, t, :, 0], log[:, t, :, 1] = c, s
        x0 = torch.tensor([_label_at(j, r, k) for j in range(h)])
        x1 = torch.tensor([_label_at(k - 1 - j, r, k) for j in range(h)])
        pi, qi = torch.minimum(x0, x1), torch.maximum(x0, x1)
        # the tiles {p_i, q_i} x {p_j, q_j} of every CTA's slots j
        P = [0 if p["label"][0] < p["label"][1] else 1 for _, p in plans]
        col = [[index((rank, p["col"][e])) for rank, p in plans] for e in range(2)]
        dst = [[index(p["dst"][e]) for _, p in plans] for e in range(2)]
        cp = torch.tensor([col[P[n]][n] for n in range(h)])[:, None]
        cq = torch.tensor([col[1 - P[n]][n] for n in range(h)])[:, None]
        xpp, xqp = S[:, cp, pi[None, :]], S[:, cp, qi[None, :]]
        xpq, xqq = S[:, cq, pi[None, :]], S[:, cq, qi[None, :]]
        ci, si = c[:, None, :], s[:, None, :]
        cj, sj = c[:, :, None], s[:, :, None]
        rpp, rpq = ci * xpp - si * xqp, ci * xpq - si * xqq
        rqp, rqq = si * xpp + ci * xqp, si * xpq + ci * xqq
        npp, npq = cj * rpp - sj * rpq, sj * rpp + cj * rpq
        nqp, nqq = cj * rqp - sj * rqq, sj * rqp + cj * rqq
        # the columns that leave an arc go into the next arc's spare column,
        # which no slot of this round reads
        used = set(col[0]) | set(col[1])
        moved = [d for e in range(2) for d, c0 in zip(dst[e], col[e]) if d != c0]
        assert not used.intersection(moved) and len(set(moved)) == len(moved)
        # in place, then the columns that leave an arc copied into the next
        # arc's spare; each column's next-round inputs read from it
        S[:, cp, pi[None, :]], S[:, cp, qi[None, :]] = npp, nqp
        S[:, cq, pi[None, :]], S[:, cq, qi[None, :]] = npq, nqq
        for e in range(2):
            for c0, d in zip(col[e], dst[e]):
                if d != c0:
                    S[:, d] = S[:, c0]
        mail = W.new_full((B, C * g.M, 2, 2), float("nan"))
        j = torch.tensor([rank * g.M + n - g.arcs(rank)[0]
                          for n, (rank, _) in enumerate(plans)])
        for e in range(2):
            cc = torch.tensor(col[e])
            lb = torch.tensor([p["label"][e] for _, p in plans])
            npart = torch.tensor([p["next"][e] for _, p in plans])
            mail[:, j, e, 0] = S[:, cc, lb]
            mail[:, j, e, 1] = S[:, cc, npart]
        if (t + 1) % (k - 1) == 0:
            snapshot(t + 1)
    return out


def _case(B, k, dtype, seed):
    """W: a symmetric Gaussian stack with a small asymmetric part (the
    kernel reads W[p, q], never W[q, p], in the first round), and V0 a
    random orthogonal basis."""
    rng = np.random.default_rng(seed)
    W = sym_stack(B, k, seed) + 1e-3 * rng.standard_normal((B, k, k))
    V0, _ = np.linalg.qr(rng.standard_normal((B, k, k)))
    return torch.as_tensor(W, dtype=dtype), torch.as_tensor(V0, dtype=dtype)


# k and the cluster sizes whose CTAs hold equal slot ranges
_CASES = [(k, C) for k in (2, 50, 56, 64, 96, 128) for C in JE.CLUSTER_SIZES
          if C <= k // 2 and (k // 2) % C == 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k,C", _CASES)
def test_cluster_scheme_is_the_plain_version(k, C, dtype):
    """The cluster kernel's scheme (cluster_rounds) gives jacobi_eigh's bits
    from V0 after 0, 1, 2 and 3 sweeps: diag W and V."""
    W, V0 = _case(2, k, dtype, seed=k + C)
    for sweeps, (d, V) in enumerate(cluster_rounds(W, V0, 3, C)):
        w_ref, V_ref = teigh.jacobi_eigh(W, sweeps, V0=V0)
        assert torch.equal(d, w_ref) and torch.equal(V, V_ref), (k, C, sweeps)


@pytest.mark.parametrize("k,C", [(50, 2), (50, 16), (130, 16), (58, 4)])
def test_cluster_scheme_with_uneven_slot_ranges(k, C):
    """Where C does not divide the k/2 slots, CTA r owns [r h / C, (r+1) h /
    C): the scheme still gives jacobi_eigh's bits (2 sweeps, float64)."""
    W, V0 = _case(1, k, torch.float64, seed=k * C)
    d, V = cluster_rounds(W, V0, 2, C)[-1]
    w_ref, V_ref = teigh.jacobi_eigh(W, 2, V0=V0)
    assert torch.equal(d, w_ref) and torch.equal(V, V_ref)


def test_label_formula_is_the_round_robin_schedule():
    """The kernel's labels (players[x] after r shifts) are the pairs of
    _round_robin_rounds round by round, each slot's (min, max)."""
    for k in (2, 4, 50, 128, 258):
        for r, (p, q) in enumerate(teigh._round_robin_rounds(k)):
            x0 = [_label_at(i, r, k) for i in range(k // 2)]
            x1 = [_label_at(k - 1 - i, r, k) for i in range(k // 2)]
            assert np.minimum(x0, x1).tolist() == p.tolist()
            assert np.maximum(x0, x1).tolist() == q.tolist()
            assert all(_position_of(_label_at(x, r, k), r, k) == x for x in range(k))


@pytest.mark.parametrize("dtype,last,first_out", [(torch.float32, 896, 898),
                                                  (torch.float64, 608, 610)])
def test_kernel_for_routes_by_the_cluster_bytes(dtype, last, first_out):
    """kernel_for(k, dtype): even 4..48 to jacobi_eig; 2 and the even sides
    above 48 whose W fits a cluster of 16 CTAs' shared memory (227 KB each)
    to jacobi_eig_cluster, up to 896 in float32 and 608 in float64; the
    even sides past that to jacobi_eig_grid while W fits the cooperative
    grid's shared memory, then to jacobi_eig_large, up to 65,536; odd sides
    to none."""
    size = dtype.itemsize
    assert JE.cluster_smem_bytes(last, 16, size) <= JE.SMEM_MAX
    assert JE.cluster_smem_bytes(first_out, 16, size) > JE.SMEM_MAX
    for k in (2, 50, 56, 64, 128, 192, 256, 258, 512, last):
        assert JE.kernel_for(k, dtype) == "jacobi_eig_cluster", k
    for k in (first_out, first_out + 2, 1024):
        assert JE.kernel_for(k, dtype) == "jacobi_eig_grid", k
    for k in (4096, 65536):
        assert JE.kernel_for(k, dtype) == "jacobi_eig_large", k
    for k in (4, 16, 48):
        assert JE.kernel_for(k, dtype) == "jacobi_eig"
    for k in (1, 3, 49, 51, 897, 65538):
        assert JE.kernel_for(k, dtype) is None
    assert all(JE.kernel_for(k, dtype) == "jacobi_eig_cluster"
               for k in range(50, last + 1, 2))
    assert JE.cluster_kernel_takes(2, dtype) and not JE.cluster_kernel_takes(48, dtype)


def test_cluster_size_fills_one_wave_with_the_fewest_ctas():
    """cluster_size: the smallest cluster of at least CLUSTER_MIN CTAs that
    holds W, runs the B clusters in one wave and turns at most
    CLUSTER_TILES tiles a CTA a round; if none turns so few, the largest
    that fits in one wave; without one wave, the fewest waves."""
    def roomy(c):
        return 132 // c

    # [8, 256] f64: 4 CTAs a matrix would turn 128 x 32 tiles each, 8 turn
    # 128 x 16
    assert JE.cluster_size(8, 256, 8, roomy) == 8
    # [1, 896] f32: only 16 hold W
    assert JE.cluster_size(1, 896, 4, roomy) == 16
    # maxcut-10k's amortized buckets: 4, though fewer would do
    for B, k in ((5, 64), (17, 96), (8, 128), (5, 192)):
        assert JE.cluster_size(B, k, 4, roomy) == 4, k
    # side 2: one slot, one CTA
    assert JE.cluster_size(3, 2, 8, roomy) == 1
    # 16 clusters of 16 do not fit one wave on a card that holds 7
    assert JE.cluster_size(16, 896, 4, lambda c: 7 if c == 16 else 0) == 16
    assert JE.cluster_size(9, 256, 8, lambda c: {8: 8, 16: 7}.get(c, 0)) == 8
    assert JE.cluster_size(12, 256, 8, lambda c: {8: 12, 16: 7}.get(c, 0)) == 8
    assert JE.cluster_size(12, 512, 4, lambda c: {8: 11, 16: 12}.get(c, 0)) == 16
    with pytest.raises(ValueError, match="no cluster"):
        JE.cluster_size(1, 896, 4, lambda c: 0)


def test_cluster_launcher_refuses_before_any_build():
    """jacobi_eig_cluster_cuda refuses a CPU tensor, an odd side, a side of
    the small kernel and a float64 side past the cluster's bytes, before
    the library is built."""
    stale = torch.tensor(True)
    for k in (5, 16, 50, 610):
        W = torch.zeros(1, k, k, dtype=torch.float64)
        with pytest.raises(ValueError):
            JE.jacobi_eig_cluster_cuda(W, W.clone(), stale, 2, 8)
