"""The slot algebra of the Jacobi kernels' register body
(cosmo_tpu_torch/csrc/jacobi_rounds.cuh), emulated on the CPU.

The kernels keep a matrix's rows at slots: k/2 lanes, lane t holding the
rows at slots 2t and 2t+1, with the columns held by label. Each round
rotates every slot pair (2t, 2t+1), then moves the rows by one fixed
permutation of the slots, the circle rotation 1 -> 2 -> 4 -> ... -> k-2 ->
k-1 -> k-3 -> ... -> 3 -> 1 with slot 0 fixed, for both schedules. The
schedules differ only in the label each slot starts with and in which label
of a pair is p. This emulation follows that data flow with the kernel's own
closed forms (``cycle_slot``, ``cycle_place``, ``origin``, ``start_label``)
and must reproduce the plain versions that the kernels are held to on the
card."""
import numpy as np
import pytest
import torch

from cosmo_tpu.ops import eigh as jeigh
from cosmo_tpu_torch.ops import eigh as E
from cosmo_tpu_torch.ops import jacobi_proj as J
from cosmo_tpu_torch.ops import jacobi_proj_rr as R

from _torch_port import sym_stack

torch.set_num_threads(1)

SIDES = list(range(4, 17, 2))


def cycle_slot(k, m):
    return 1 if m == 0 else (2 * m if m < k // 2 else 2 * k - 1 - 2 * m)


def cycle_place(k, s):
    return 0 if s == 1 else (s // 2 if s % 2 == 0 else (2 * k - 1 - s) // 2)


def origin(k, r, s):
    """The slot whose round-0 row sits at slot s after r rounds."""
    return 0 if s == 0 else cycle_slot(k, (cycle_place(k, s) - r) % (k - 1))


# (start label of slot s, p is the smaller label) of each kernel's schedule
SCHEDULES = {
    "jacobi_proj": (lambda k, s: s // 2 if s % 2 == 0 else k - 1 - s // 2, True),
    "jacobi_proj_rr": (lambda k, s: s, False),
}
PLAIN = {"jacobi_proj": J.psd_project_jacobi_plain,
         "jacobi_proj_rr": R.psd_project_jacobi_rr_plain}
# the rounds each plain version hands ops/eigh.py (None: round-robin)
ROUNDS = {"jacobi_proj": lambda k: None,
          "jacobi_proj_rr": lambda k: [(t[:, 0], t[:, 1]) for t in R.pair_table(k)]}


def labels(name, k, r):
    start, _ = SCHEDULES[name]
    return [start(k, origin(k, r, s)) for s in range(k)]


def pairs(name, k, r):
    """Round r's (p, q) of each slot pair, as the kernel orients them."""
    lab, p_is_min = labels(name, k, r), SCHEDULES[name][1]
    out = []
    for u in range(k // 2):
        a, b = lab[2 * u], lab[2 * u + 1]
        out.append((min(a, b), max(a, b)) if p_is_min else (a, b))
    return out


def move_rows(k):
    """Index array: the new slot s takes the row of slot src[s]."""
    H = k // 2
    src = np.empty(k, dtype=np.int64)
    for t in range(H):
        src[2 * t] = 0 if t == 0 else (1 if t == 1 else 2 * t - 2)
        src[2 * t + 1] = k - 2 if t == H - 1 else 2 * t + 3
    return src


def emulate(name, X, sweeps):
    """The register body's data flow on a [B, k, k] float64 tensor:
    returns (diag X, V) after ``sweeps`` sweeps."""
    B, k, _ = X.shape
    start = [SCHEDULES[name][0](k, s) for s in range(k)]
    Xs = X[:, start, :].clone()               # rows by slot, columns by label
    V = torch.eye(k, dtype=X.dtype).expand(B, k, k).clone()
    src = torch.as_tensor(move_rows(k))
    for _ in range(sweeps):
        for r in range(k - 1):
            lab = labels(name, k, r)
            pq = pairs(name, k, r)
            p = torch.tensor([a for a, _ in pq])
            q = torch.tensor([b for _, b in pq])
            # the slots of p and q in each lane's pair
            sp = torch.tensor([2 * u + (lab[2 * u] != a) for u, (a, _) in enumerate(pq)])
            sq = torch.tensor([2 * u + (lab[2 * u] == a) for u, (a, _) in enumerate(pq)])
            c, s = E.rotation_angles(Xs[:, sp, p], Xs[:, sq, q], Xs[:, sp, q])
            cc, ss = c[:, :, None], s[:, :, None]
            rp, rq = Xs[:, sp, :], Xs[:, sq, :]   # lane-local rows
            Xs[:, sp, :] = cc * rp - ss * rq
            Xs[:, sq, :] = ss * rp + cc * rq
            cr, sr = c[:, None, :], s[:, None, :]
            for M in (Xs, V):                      # columns by label
                cp, cq = M[:, :, p], M[:, :, q]
                M[:, :, p] = cr * cp - sr * cq
                M[:, :, q] = sr * cp + cr * cq
            Xs = Xs[:, src, :]
        # period k - 1: the rows are at their starting slots again
        assert labels(name, k, k - 1) == start
        Xl = torch.empty_like(Xs)
        Xl[:, start, :] = Xs
        Xl = 0.5 * (Xl + Xl.transpose(1, 2))
        Xs = Xl[:, start, :]
    Xl = torch.empty_like(Xs)
    Xl[:, start, :] = Xs
    return torch.diagonal(Xl, dim1=-2, dim2=-1), V


def guard_stack(B, k, seed):
    """Gaussian symmetric matrices, one with equal diagonal entries
    (tau = 0 in the first rounds) and one diagonal (exact zeros off the
    diagonal: identity rotations)."""
    X = sym_stack(B, k, seed)
    X[0] = 0.25
    X[0][np.diag_indices(k)] = 1.0
    X[1] = np.diag(np.arange(k) % 3 - 1.0)
    return torch.as_tensor(X)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("k", SIDES)
def test_emulated_register_body_matches_plain(name, k):
    """f64, 2 sweeps: the emulation and the plain version apply the same
    rotations in the same order, so they agree to 1e-13 of max |X|, in the
    eigenpairs too (there the orientation of a tau = 0 pair shows: it
    flips the sign of a rotation)."""
    X = guard_stack(12, k, seed=k)
    scale = X.abs().max().item()
    w, V = emulate(name, X, 2)
    rw, rV = E.jacobi_eigh(X, 2, rounds=ROUNDS[name](k))
    assert (w - rw).abs().max().item() <= 1e-13 * scale
    assert (V - rV).abs().max().item() <= 1e-13
    got = E.psd_reconstruct(w, V)
    assert (got - PLAIN[name](X, 2)).abs().max().item() <= 1e-13 * scale


@pytest.mark.parametrize("k", SIDES + [24, 48])
def test_slot_labels_give_each_schedule(k):
    """The closed forms give, round by round, the pairs of
    ``cosmo_tpu.ops.eigh._round_robin_rounds`` (as p = min, q = max) and of
    the round-parallel kernel's pair table (p at slot 2t)."""
    ref = jeigh._round_robin_rounds(k)
    for r in range(k - 1):
        got = pairs("jacobi_proj", k, r)
        assert sorted(got) == sorted(zip(ref[r][0].tolist(), ref[r][1].tolist()))
        assert pairs("jacobi_proj_rr", k, r) == [tuple(map(int, pq)) for pq in R.pair_table(k)[r]]


@pytest.mark.parametrize("k", SIDES + [24, 48])
def test_row_move_is_the_circle_rotation(k):
    """Moving the rows by ``move_rows`` turns round r's slot labels into
    round r + 1's, and k - 1 moves are the identity."""
    src = move_rows(k)
    for name in SCHEDULES:
        for r in range(k - 1):
            assert [labels(name, k, r)[i] for i in src] == labels(name, k, r + 1)
    perm = np.arange(k)
    for _ in range(k - 1):
        perm = perm[src]
    assert np.array_equal(perm, np.arange(k))
