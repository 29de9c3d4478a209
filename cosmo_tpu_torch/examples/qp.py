"""Quadratic program (reference: examples/qp.jl).

    min 1/2 x'Px + q'x   s.t.  l <= Ax <= u

Known solution: x* = [0.3, 0.7], obj* = 1.88.
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    q = np.array([1.0, 1.0])
    P = np.array([[4.0, 1.0], [1.0, 2.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    l = np.array([1.0, 0.0, 0.0])
    u = np.array([1.0, 0.7, 0.7])

    # one-sided formulation with Nonnegatives
    Aa = np.vstack([-A, A])
    ba = np.concatenate([u, -l])
    con = cosmo.Constraint(Aa, ba, cosmo.Nonnegatives)
    model = cosmo.Model(device=device)
    model.assemble(P, q, [con], settings=settings(verbose=True))
    res = model.optimize()

    # two-sided formulation with Box
    con_box = cosmo.Constraint(A, np.zeros(3), cosmo.Box(l, u))
    model_box = cosmo.Model(device=device)
    model_box.assemble(P, q, [con_box], settings=settings())
    res_box = model_box.optimize()

    assert np.abs(res.x - [0.3, 0.7]).max() < 1e-3, res.x
    assert np.abs(res_box.x - [0.3, 0.7]).max() < 1e-3, res_box.x
    assert abs(res.obj_val - 1.88) < 1e-3
    assert abs(res_box.obj_val - 1.88) < 1e-3
    print("qp example OK:", res.x, res.obj_val)


if __name__ == "__main__":
    run(main, __doc__)
