"""Smallest/largest eigenvalue via SDP (reference:
examples/maxEigenvalue.jl, test/UnitTests/least_eigenvalue.jl):

    lambda_max(C) = min t  s.t.  t I - C  PSD
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings
from cosmo_tpu_torch.problems import svec, tri_dim


def main(device=None):
    rng = np.random.default_rng(5)
    n = 10
    G = rng.standard_normal((n, n))
    Cmat = 0.5 * (G + G.T)

    # variable t; constraint t*I - C in PSD triangle
    d = tri_dim(n)
    A = svec(np.eye(n)).reshape(d, 1)
    b = -svec(Cmat)
    con = cosmo.Constraint(A, b, cosmo.PsdConeTriangle(d))

    model = cosmo.Model(settings(eps_abs=1e-7, eps_rel=1e-7), device=device)
    model.assemble(np.zeros((1, 1)), np.array([1.0]), [con])
    res = model.optimize()
    assert res.status == "Solved"

    lam_max = np.linalg.eigvalsh(Cmat).max()
    print("t* =", res.x[0], " lambda_max =", lam_max)
    assert abs(res.x[0] - lam_max) < 1e-4
    print("max eigenvalue example OK")


if __name__ == "__main__":
    run(main, __doc__)
