"""Sum-of-squares certificate via SDP (reference: examples/sum_of_squares.jl,
the Motzkin example from SumOfSquares.jl).

The Motzkin polynomial m(x,y) = x^4 y^2 + x^2 y^4 + 1 - 3 x^2 y^2 is
nonnegative but NOT a sum of squares; multiplying by (x^2 + y^2) makes it
SOS. The SOS certificate is a Gram matrix: p(x,y) = z(x,y)' Q z(x,y) with
Q >= 0 over the monomial basis z of degree <= 4 — matching coefficients
gives linear equality constraints on svec(Q), so the certificate is the
feasibility SDP  find svec(Q)  s.t.  A svec(Q) = b,  Q PSD.
"""
import itertools

import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings
from cosmo_tpu_torch.problems import smat, tri_dim


def tri_index(r, c):
    """tri index of (r, c), r <= c, in the svec column order."""
    r, c = min(r, c), max(r, c)
    return c * (c + 1) // 2 + r


def main(device=None):
    # p = (x^2 + y^2) * motzkin, as {(i, j): coeff} for x^i y^j
    motzkin = {(4, 2): 1.0, (2, 4): 1.0, (0, 0): 1.0, (2, 2): -3.0}
    p = {}
    for (i, j), c in motzkin.items():
        for di, dj in ((2, 0), (0, 2)):
            p[(i + di, j + dj)] = p.get((i + di, j + dj), 0.0) + c

    # monomial basis of degree <= 4 (p is not homogeneous: it has a constant)
    basis = [(i, j) for t in range(5) for i, j in
             [(i, t - i) for i in range(t + 1)]]
    nb = len(basis)                               # 15 monomials
    d = tri_dim(nb)

    # coefficient-matching rows: for every monomial of degree <= 8,
    # sum_{(a,b): a+b = mono} Q[a, b] = p[mono]
    rows = {}
    for a, b in itertools.combinations_with_replacement(range(nb), 2):
        mono = (basis[a][0] + basis[b][0], basis[a][1] + basis[b][1])
        scale = (1.0 if a == b else 2.0)          # Q[a,b] + Q[b,a]
        svec_scale = 1.0 if a == b else np.sqrt(2.0)
        rows.setdefault(mono, {})[tri_index(a, b)] = scale / svec_scale

    monos = sorted(rows)
    A_eq = np.zeros((len(monos), d))
    b_eq = np.zeros(len(monos))
    for r, mono in enumerate(monos):
        for cidx, v in rows[mono].items():
            A_eq[r, cidx] = v
        b_eq[r] = p.get(mono, 0.0)

    cons = [
        cosmo.Constraint(A_eq, -b_eq, cosmo.ZeroSet),
        cosmo.Constraint(np.eye(d), np.zeros(d), cosmo.PsdConeTriangle(d)),
    ]
    # rho = 1e-5 like the reference example: a pure feasibility SDP (q = 0)
    # wants a tiny rho so the iterates move onto the affine slice first
    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6, rho=1e-5,
                                 decompose=False, max_iter=20000), device=device)
    model.assemble(np.zeros((d, d)), np.zeros(d), cons)
    res = model.optimize()
    assert res.status == "Solved", res.status

    # verify the certificate: reconstruct Q, check PSD + coefficient match
    Q = smat(res.x)
    lam_min = np.linalg.eigvalsh(Q).min()
    resid = np.abs(A_eq @ res.x - b_eq).max()
    print("lambda_min(Q) =", lam_min, " max coeff residual =", resid)
    assert lam_min > -1e-5 and resid < 1e-5
    print("sum-of-squares example OK: (x^2+y^2)*motzkin certified SOS")


if __name__ == "__main__":
    run(main, __doc__)
