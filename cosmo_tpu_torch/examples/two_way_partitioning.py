"""Two-way partitioning SDP relaxation (reference:
examples/two_way_partitioning.jl; Boyd & Vandenberghe ex. 5.39):

    lower bound on  min x'Wx, x in {-1,1}^n  via
    max -1'y  s.t.  W + diag(y) PSD
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings
from cosmo_tpu_torch.problems import svec, tri_dim


def main(device=None):
    rng = np.random.default_rng(11)
    n = 12
    G = rng.standard_normal((n, n))
    W = 0.5 * (G + G.T)

    # min 1'y s.t. W + diag(y) in PSD  (bound = -1'y*)
    d = tri_dim(n)
    A = np.zeros((d, n))
    for i in range(n):
        A[:, i] = svec(np.outer(np.eye(n)[i], np.eye(n)[i]))
    b = svec(W)
    con = cosmo.Constraint(A, b, cosmo.PsdConeTriangle(d))

    model = cosmo.Model(settings(eps_abs=1e-7, eps_rel=1e-7), device=device)
    model.assemble(np.zeros((n, n)), np.ones(n), [con])
    res = model.optimize()
    assert res.status == "Solved"
    bound = -res.obj_val

    # the bound must be below the value of any feasible partition
    best = min(x @ W @ x for x in (np.sign(rng.standard_normal(n)) for _ in range(50)))
    print("SDP lower bound:", bound, " best random partition:", best)
    assert bound <= best + 1e-5
    print("two-way partitioning example OK")


if __name__ == "__main__":
    run(main, __doc__)
