"""Closest correlation matrix (reference:
examples/closest_correlation_matrix.jl):

    min 1/2 ||X - C||_F^2   s.t.  X_ii = 1, X PSD
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch import problems
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    P, q, A, b, sets, Cmat = problems.closest_correlation(n=12, seed=1)
    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6, verbose=True), device=device)
    model.set(P, q, A, b, sets)
    res = model.optimize()
    assert res.status == "Solved"

    X = problems.smat(res.s[12:])  # first 12 rows are the ZeroSet diag rows
    assert np.abs(np.diag(X) - 1.0).max() < 1e-4
    assert np.linalg.eigvalsh(X).min() > -1e-6
    print("closest correlation OK, distance:", np.linalg.norm(X - Cmat))


if __name__ == "__main__":
    run(main, __doc__)
