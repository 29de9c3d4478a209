"""Primal soft-margin SVM as a QP (reference: examples/svm_primal.jl):

    min ||w||^2 + C sum_i max(0, 1 - y_i (w'z_i - b))
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    rng = np.random.default_rng(9)
    N, d = 40, 2
    Zpos = rng.standard_normal((N // 2, d)) + 2.0
    Zneg = rng.standard_normal((N // 2, d)) - 2.0
    Z = np.vstack([Zpos, Zneg])
    y = np.concatenate([np.ones(N // 2), -np.ones(N // 2)])
    Creg = 1.0

    # variables: [w (d); b (1); xi (N)]
    nvar = d + 1 + N
    P = np.zeros((nvar, nvar))
    P[:d, :d] = 2 * np.eye(d)
    q = np.concatenate([np.zeros(d + 1), Creg * np.ones(N)])

    # y_i (w'z_i - b) >= 1 - xi_i   and   xi >= 0
    A1 = np.zeros((N, nvar))
    A1[:, :d] = y[:, None] * Z
    A1[:, d] = -y
    A1[:, d + 1:] = np.eye(N)
    c1 = cosmo.Constraint(A1, -np.ones(N), cosmo.Nonnegatives)
    A2 = np.zeros((N, nvar))
    A2[:, d + 1:] = np.eye(N)
    c2 = cosmo.Constraint(A2, np.zeros(N), cosmo.Nonnegatives)

    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6), device=device)
    model.assemble(P, q, [c1, c2])
    res = model.optimize()
    assert res.status == "Solved"
    w, bb = res.x[:d], res.x[d]
    acc = np.mean(np.sign(Z @ w - bb) == y)
    print("svm train accuracy:", acc)
    assert acc >= 0.95
    print("svm example OK")


if __name__ == "__main__":
    run(main, __doc__)
