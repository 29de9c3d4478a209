"""Sum of absolute values of the k largest eigenvalues via SDP (reference:
examples/sum_abs_k_eigenvalues.jl, Alizadeh's primal form):

    maximize    tr(A Y) - tr(A W)
    subject to  tr(Y + W) = k,   0 <= Y <= I,   0 <= W <= I

whose optimum equals sum_{i<=k} |lambda_i(A)| sorted by |.| descending.
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings
from cosmo_tpu_torch.problems import svec, tri_dim


def main(device=None):
    rng = np.random.default_rng(212)
    n, k = 10, 3
    G = 5.0 * rng.standard_normal((n, n))
    Amat = np.triu(G) + np.triu(G, 1).T          # symmetric

    d = tri_dim(n)
    nvar = 2 * d                                  # x = [svec(Y); svec(W)]
    I_sv = svec(np.eye(n))

    # maximize tr(AY) - tr(AW) -> minimize -<svec(A), svec(Y)> + <svec(A), svec(W)>
    q = np.concatenate([-svec(Amat), svec(Amat)])

    cons = [
        # tr(Y + W) = k   (<svec(I), .> on both blocks)
        cosmo.Constraint(np.concatenate([I_sv, I_sv]).reshape(1, -1),
                         np.array([-float(k)]), cosmo.ZeroSet),
        # Y >= 0, W >= 0
        cosmo.Constraint(np.hstack([np.eye(d), np.zeros((d, d))]), np.zeros(d),
                         cosmo.PsdConeTriangle(d)),
        cosmo.Constraint(np.hstack([np.zeros((d, d)), np.eye(d)]), np.zeros(d),
                         cosmo.PsdConeTriangle(d)),
        # I - Y >= 0, I - W >= 0
        cosmo.Constraint(np.hstack([-np.eye(d), np.zeros((d, d))]), I_sv,
                         cosmo.PsdConeTriangle(d)),
        cosmo.Constraint(np.hstack([np.zeros((d, d)), -np.eye(d)]), I_sv,
                         cosmo.PsdConeTriangle(d)),
    ]

    model = cosmo.Model(settings(eps_abs=1e-7, eps_rel=1e-7,
                                 decompose=False, max_iter=20000), device=device)
    model.assemble(np.zeros((nvar, nvar)), q, cons)
    res = model.optimize()
    assert res.status == "Solved", res.status

    truth = np.sort(np.abs(np.linalg.eigvalsh(Amat)))[::-1][:k].sum()
    print("objective =", -res.obj_val, " sum |lambda|_k =", truth)
    assert abs(-res.obj_val - truth) < 1e-3 * max(1.0, truth)
    print("sum-abs-k-eigenvalues example OK")


if __name__ == "__main__":
    run(main, __doc__)
