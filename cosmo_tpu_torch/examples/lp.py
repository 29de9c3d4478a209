"""Linear program (reference: examples/lp.jl).

    min c'x  s.t.  Ax <= b, x >= 1, x2 >= 5, x1 + x3 >= 4

Known solution: x* = [3, 5, 1, 1], obj* = 20.
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    c = np.array([1.0, 2.0, 3.0, 4.0])
    A = np.eye(4)
    b = np.full(4, 10.0)
    n = 4

    c1 = cosmo.Constraint(-A, b, cosmo.Nonnegatives)               # Ax <= b
    c2 = cosmo.Constraint(np.eye(n), -np.ones(n), cosmo.Nonnegatives)  # x >= 1
    c3 = cosmo.Constraint(1.0, -5.0, cosmo.Nonnegatives, dim=n, indices=[1])  # x2 >= 5
    c4 = cosmo.Constraint(np.array([[1.0, 0, 1, 0]]), -4.0, cosmo.Nonnegatives)  # x1+x3 >= 4

    P = np.zeros((4, 4))
    model = cosmo.Model(device=device)
    model.assemble(
        P, c, [c1, c2, c3, c4],
        settings=settings(verbose=True, eps_abs=1e-4, eps_rel=1e-5),
    )
    res = model.optimize()

    assert np.abs(res.x - [3, 5, 1, 1]).max() < 1e-2, res.x
    assert abs(res.obj_val - 20.0) < 1e-2
    print("lp example OK:", res.x, res.obj_val)


if __name__ == "__main__":
    run(main, __doc__)
