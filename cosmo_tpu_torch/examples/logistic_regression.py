"""L2-regularised logistic regression via exponential cones (reference:
examples/logistic_regression.jl).

    min sum_i log(1 + exp(-y_i w'z_i)) + lam ||w||^2

Each softplus term log(1+exp(a_i)) <= t_i is modeled with two exponential
cones: exp(a_i - t_i) + exp(-t_i) <= 1.
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    rng = np.random.default_rng(3)
    N, d = 30, 3
    Z = rng.standard_normal((N, d))
    w_true = rng.standard_normal(d)
    y = np.sign(Z @ w_true + 0.3 * rng.standard_normal(N))
    lam = 0.1

    # variables: [w (d); t (N); u (N); v (N)]   u_i >= exp(a_i - t_i),
    # v_i >= exp(-t_i), u_i + v_i <= 1, a_i = -y_i z_i'w
    nvar = d + 3 * N
    P = np.zeros((nvar, nvar))
    P[:d, :d] = 2 * lam * np.eye(d)
    q = np.concatenate([np.zeros(d), np.ones(N), np.zeros(2 * N)])

    cons = []
    for i in range(N):
        ai = -y[i] * Z[i]
        # (a_i - t_i, 1, u_i) in K_exp, as A x + b in K
        A1 = np.zeros((3, nvar))
        b1 = np.zeros(3)
        A1[0, :d] = ai
        A1[0, d + i] = -1.0
        b1[1] = 1.0
        A1[2, d + 2 * N + i] = 1.0
        cons.append(cosmo.Constraint(A1, b1, cosmo.ExponentialCone()))
        # (-t_i, 1, v_i) in K_exp, v stored at the u slot + N
        A2 = np.zeros((3, nvar))
        b2 = np.zeros(3)
        A2[0, d + i] = -1.0
        b2[1] = 1.0
        A2[2, d + N + i] = 1.0
        cons.append(cosmo.Constraint(A2, b2, cosmo.ExponentialCone()))
    # u_i + v_i <= 1
    A3 = np.zeros((N, nvar))
    A3[:, d + N: d + 2 * N] = -np.eye(N)
    A3[:, d + 2 * N:] = -np.eye(N)
    cons.append(cosmo.Constraint(A3, np.ones(N), cosmo.Nonnegatives))

    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=10000),
                        device=device)
    model.assemble(P, q, cons)
    res = model.optimize()
    assert res.status == "Solved", res.status
    w_hat = res.x[:d]

    def loss(w):
        return np.sum(np.logaddexp(0.0, -y * (Z @ w))) + lam * w @ w

    print("logistic loss:", loss(w_hat), "vs true-gen w:", loss(w_true))
    assert loss(w_hat) <= loss(w_true) + 1e-2
    # near-stationarity by a central-difference gradient
    eps = 1e-5
    g = np.array([(loss(w_hat + eps * e) - loss(w_hat - eps * e)) / (2 * eps)
                  for e in np.eye(d)])
    assert np.abs(g).max() < 5e-2, g
    print("logistic regression example OK")


if __name__ == "__main__":
    run(main, __doc__)
