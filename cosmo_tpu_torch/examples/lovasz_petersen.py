"""Lovász theta number of the Petersen graph (reference:
examples/lovasz_petersen.jl). Known value: theta = 4.

    theta(G) = max <J, X>  s.t.  tr(X) = 1, X_ij = 0 for (i,j) in E, X PSD
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings
from cosmo_tpu_torch.problems import smat, svec, tri_dim

# Petersen graph: outer 5-cycle, inner pentagram, spokes
EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0),
         (5, 7), (7, 9), (9, 6), (6, 8), (8, 5),
         (0, 5), (1, 6), (2, 7), (3, 8), (4, 9)]


def main(device=None):
    n = 10
    d = tri_dim(n)

    def svec_unit(i, j):
        v = np.zeros(d)
        k = j * (j + 1) // 2 + i if i <= j else i * (i + 1) // 2 + j
        v[k] = 1.0
        return v

    # variables x = svec(X); maximize <J, X> = svec(J)' x (J all-ones)
    J = np.ones((n, n))
    q = -svec(J)  # minimize -<J, X>
    P = np.zeros((d, d))

    rows = []
    bs = []
    # tr(X) = 1
    rows.append(svec(np.eye(n)))
    bs.append(1.0)
    # X_ij = 0 on edges
    for (i, j) in EDGES:
        rows.append(svec_unit(i, j) * np.sqrt(2.0))  # svec entry == sqrt2 X_ij
        bs.append(0.0)
    A1 = np.vstack(rows)
    b1 = np.array(bs)

    # PSD constraint on x itself
    A = np.vstack([A1, -np.eye(d)])
    b = np.concatenate([b1, np.zeros(d)])
    sets = [cosmo.ZeroSet(len(b1)), cosmo.PsdConeTriangle(d)]

    model = cosmo.Model(settings(eps_abs=1e-7, eps_rel=1e-7, decompose=False),
                        device=device)
    model.set(P, q, A, b, sets)
    res = model.optimize()
    theta = -res.obj_val
    print("theta(Petersen) =", theta)
    assert res.status == "Solved"
    assert abs(theta - 4.0) < 1e-3
    X = smat(res.s[len(b1):])
    assert np.linalg.eigvalsh(X).min() > -1e-6
    print("lovasz theta example OK")


if __name__ == "__main__":
    run(main, __doc__)
