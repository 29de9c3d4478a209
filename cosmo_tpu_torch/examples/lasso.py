"""LASSO as an SOCP (reference: test/UnitTests/socp-lasso.jl):

    min 1/2 ||Ax - b||^2 + lam ||x||_1

modeled with an epigraph variable t for the residual norm-squared via a
second-order cone and box variables for |x|.
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    rng = np.random.default_rng(1)
    m_d, n_d = 30, 15
    Ad = rng.standard_normal((m_d, n_d))
    x_true = np.where(rng.random(n_d) < 0.3, rng.standard_normal(n_d), 0.0)
    bd = Ad @ x_true + 0.01 * rng.standard_normal(m_d)
    lam = 0.1

    # variables z = [t; x; u] with t >= ||Ax - b||^2 (rotated cone via SOC),
    # u >= |x|:  min 1/2 t + lam 1'u
    nvar = 1 + 2 * n_d
    P = np.zeros((nvar, nvar))
    q = np.concatenate([[0.5], np.zeros(n_d), lam * np.ones(n_d)])

    # (1+t)/2, (1-t)/2, Ax - b  in SOC  <=>  t >= ||Ax-b||^2
    Asoc = np.zeros((2 + m_d, nvar))
    bsoc = np.zeros(2 + m_d)
    Asoc[0, 0] = 0.5
    bsoc[0] = 0.5
    Asoc[1, 0] = -0.5
    bsoc[1] = 0.5
    Asoc[2:, 1: 1 + n_d] = Ad
    bsoc[2:] = -bd
    c_soc = cosmo.Constraint(Asoc, bsoc, cosmo.SecondOrderCone)

    # u - x >= 0 and u + x >= 0
    A1 = np.zeros((n_d, nvar))
    A1[:, 1: 1 + n_d] = -np.eye(n_d)
    A1[:, 1 + n_d:] = np.eye(n_d)
    A2 = np.zeros((n_d, nvar))
    A2[:, 1: 1 + n_d] = np.eye(n_d)
    A2[:, 1 + n_d:] = np.eye(n_d)
    c_abs1 = cosmo.Constraint(A1, np.zeros(n_d), cosmo.Nonnegatives)
    c_abs2 = cosmo.Constraint(A2, np.zeros(n_d), cosmo.Nonnegatives)

    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6), device=device)
    model.assemble(P, q, [c_soc, c_abs1, c_abs2])
    res = model.optimize()
    assert res.status == "Solved"
    x_hat = res.x[1: 1 + n_d]

    obj = 0.5 * np.sum((Ad @ x_hat - bd) ** 2) + lam * np.abs(x_hat).sum()
    obj_true = 0.5 * np.sum((Ad @ x_true - bd) ** 2) + lam * np.abs(x_true).sum()
    print("lasso objective:", obj, "(truth-ish:", obj_true, ")")
    assert obj <= obj_true + 1e-3
    print("lasso example OK")


if __name__ == "__main__":
    run(main, __doc__)
