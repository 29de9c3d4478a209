"""Infeasibility detection in cosmo_tpu_torch against cosmo_tpu, on the
CPU in float64: the ports of the nine tests of tests/test_infeasibility.py
(reference: test/UnitTests/InfeasibilityTests/). Each problem runs through
both packages at the default settings (Anderson acceleration and the
certificate shadow trajectory), and both must certify the same status."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cosmo_tpu as ct
import cosmo_tpu_torch as pt
from cosmo_tpu import problems as jprob
from cosmo_tpu_torch import problems as tprob

torch.set_num_threads(1)

BATTERY = dict(eps_abs=1e-5, eps_rel=1e-5, max_iter=10000)


def _status_both(build, settings=None):
    """The statuses of ``build(mod, model)`` solved by both packages."""
    out = []
    for mod, kw in ((ct, {}), (pt, dict(device="cpu"))):
        model = mod.Model(mod.Settings(**(settings or {})), **kw)
        out.append(build(mod, model).optimize().status)
    return out


def test_primal_infeasible_lp():
    """x >= 1 and x <= 0 at once."""
    def build(mod, model):
        n = 2
        return model.assemble(np.zeros((n, n)), np.ones(n), [
            mod.Constraint(np.eye(n), -np.ones(n), mod.Nonnegatives),
            mod.Constraint(-np.eye(n), np.zeros(n), mod.Nonnegatives)])
    assert _status_both(build) == ["Primal_infeasible"] * 2


def test_primal_infeasible_eq():
    """Contradictory equalities: x1 = 0 and x1 = 1."""
    def build(mod, model):
        A = np.array([[1.0, 0.0], [1.0, 0.0]])
        return model.assemble(np.eye(2), np.zeros(2), [
            mod.Constraint(A, np.array([0.0, -1.0]), mod.ZeroSet)])
    assert _status_both(build) == ["Primal_infeasible"] * 2


def test_dual_infeasible_unbounded_lp():
    """min -x1 s.t. x >= 0: unbounded below."""
    def build(mod, model):
        return model.assemble(np.zeros((2, 2)), np.array([-1.0, 0.0]), [
            mod.Constraint(np.eye(2), np.zeros(2), mod.Nonnegatives)])
    assert _status_both(build) == ["Dual_infeasible"] * 2


def test_dual_infeasible_box_direction():
    """min -x2 with x1 in [0, 1] and x2 free above: unbounded."""
    def build(mod, model):
        return model.assemble(np.zeros((2, 2)), np.array([0.0, -1.0]), [
            mod.Constraint(np.array([[1.0, 0.0]]), np.zeros(1), mod.Box([0.0], [1.0])),
            mod.Constraint(np.array([[0.0, 1.0]]), np.zeros(1), mod.Nonnegatives)])
    assert _status_both(build) == ["Dual_infeasible"] * 2


def _pos_def(rng, n, lo=0.1, hi=5.0):
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return Q @ np.diag(rng.uniform(lo, hi, n)) @ Q.T


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_primal_infeasible_random_qp_battery(seed):
    """A x + s = b, s >= 0, x >= 0 with A >= 0 and b < 0: primal infeasible
    by construction; q is dual feasible, so only the primal certificate can
    fire (reference: InfeasibilityTests/primal_infeasible_1.jl)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 30))
    m = 2 * n
    A = rng.random((m, n)) * (rng.random((m, n)) < 0.8)
    b = -rng.random(m)
    A_full = np.vstack([A, -np.eye(n)])
    b_full = np.concatenate([b, np.zeros(n)])
    P = _pos_def(rng, n)
    q = -(P @ rng.random(n)) - A_full.T @ rng.random(m + n)

    def build(mod, model):
        return model.assemble(P, q, [mod.Constraint(-A_full, b_full, mod.Nonnegatives)])
    assert _status_both(build, BATTERY) == ["Primal_infeasible"] * 2


@pytest.mark.parametrize("seed", [4, 5])
def test_primal_infeasible_random_mixed_cones(seed):
    """Zero + SOC + PSD-square rows whose SOC t-row is forced to -1
    (reference: InfeasibilityTests/primal_infeasible_3.jl)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 25))
    m1 = int(rng.integers(2, 8))
    m2 = int(rng.integers(3, 8))
    r = int(rng.integers(4, 8))
    m = m1 + m2 + r * r
    A = rng.random((m, n)) * 50 * (rng.random((m, n)) < 0.8)
    xtrue = rng.random(n) * 50
    s = np.concatenate([np.zeros(m1), rng.random(m2), _pos_def(rng, r).ravel(order="F")])
    b = A @ xtrue + s
    A[m1] = 0.0
    b[m1] = -1.0
    P = _pos_def(rng, n)
    y2 = rng.random(m2 - 1) * 50
    ytrue = np.concatenate([rng.random(m1) * 50,
                            np.concatenate([[np.linalg.norm(y2) + 1.0], y2]),
                            _pos_def(rng, r).ravel(order="F")])
    q = -(P @ xtrue) - A.T @ ytrue

    def build(mod, model):
        return model.assemble(P, q, [
            mod.Constraint(-A[:m1], b[:m1], mod.ZeroSet),
            mod.Constraint(-A[m1:m1 + m2], b[m1:m1 + m2], mod.SecondOrderCone),
            mod.Constraint(-A[m1 + m2:], b[m1 + m2:], mod.PsdCone)])
    assert _status_both(build, dict(BATTERY, decompose=False)) == ["Primal_infeasible"] * 2


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_dual_infeasible_random_lp_battery(seed):
    """P = 0, one column of A identically zero and a negative cost on it:
    unbounded along e_k (reference: InfeasibilityTests/dual_infeasible_1.jl)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 30))
    m = 2 * n
    A = rng.random((m, n)) * 50 * (rng.random((m, n)) < 0.7)
    A[:, -1] = 0.0
    q = rng.random(n) * 50
    q[-1] = -1.0
    b = A @ (rng.random(n) * 50) + rng.random(m) * 50

    def build(mod, model):
        return model.assemble(np.zeros((n, n)), q, [mod.Constraint(-A, b, mod.Nonnegatives)])
    assert _status_both(build, BATTERY) == ["Dual_infeasible"] * 2


@pytest.mark.parametrize("seed", [9, 11])
def test_dual_infeasible_random_mixed_cones(seed):
    """An unbounded direction through Zero + Nonnegatives + SOC + PSD rows:
    x1 is only in the cost (negative) and a redundant inequality
    (reference: InfeasibilityTests/dual_infeasible_2.jl)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 25))
    m1 = int(rng.integers(2, 8))
    m2 = 1
    m3 = int(rng.integers(3, 8))
    r = int(rng.integers(4, 8))
    m = m1 + m2 + m3 + r * r
    A = rng.random((m, n)) * 50 * (rng.random((m, n)) < 0.8)
    xtrue = rng.random(n) * 50
    s3 = rng.random(m3 - 1)
    s = np.concatenate([np.zeros(m1), [rng.random()],
                        np.concatenate([[np.linalg.norm(s3) + 1.0], s3]),
                        _pos_def(rng, r).ravel(order="F")])
    A[:, 0] = 0.0
    A[m1] = np.concatenate([[-1.0], np.zeros(n - 1)])
    b = A @ xtrue + s
    b[m1] = 0.0
    q = np.concatenate([[-1.0], rng.random(n - 1)])
    k = m1 + m2 + m3

    def build(mod, model):
        return model.assemble(np.zeros((n, n)), q, [
            mod.Constraint(-A[:m1], b[:m1], mod.ZeroSet),
            mod.Constraint(-A[m1:m1 + m2], b[m1:m1 + m2], mod.Nonnegatives),
            mod.Constraint(-A[m1 + m2:k], b[m1 + m2:k], mod.SecondOrderCone),
            mod.Constraint(-A[k:], b[k:], mod.PsdCone)])
    assert _status_both(build, dict(BATTERY, decompose=False)) == ["Dual_infeasible"] * 2


def test_primal_infeasible_under_decomposition():
    """The shadow-trajectory certificates fire through the chordal
    decomposition: a decomposed banded SDP with x0 = 0 and x0 = 1 added."""
    def build(mod, model):
        P, q, A, b, sets, _ = (jprob if mod is ct else tprob).banded_sdp(
            n_nodes=60, bandwidth=4, seed=0, sparse=True)
        n = A.shape[1]
        e = sp.csr_matrix((np.array([1.0, 1.0]), (np.array([0, 1]), np.array([0, 0]))),
                          shape=(2, n))
        return model.set(P, q, sp.vstack([e, A], format="csr"),
                         np.concatenate([[0.0, 1.0], b]), [mod.ZeroSet(2)] + sets)
    assert _status_both(build, dict(BATTERY, decompose=True)) == ["Primal_infeasible"] * 2
