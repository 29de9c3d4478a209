"""Markowitz portfolio optimisation with model updates (reference:
examples/portfolio_optimisation.jl and
docs/src/literate/portfolio_model_updates.jl):

    min x'Sigma x - gamma mu'x   s.t.  1'x = 1, x >= 0

re-solved for several risk aversions gamma via update() + warm re-solve.
"""
import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    rng = np.random.default_rng(7)
    n_assets = 20
    F = rng.standard_normal((n_assets, 4))
    Sigma = F @ F.T / 10 + np.diag(rng.random(n_assets) * 0.1)
    mu = rng.random(n_assets) * 0.1

    budget = cosmo.Constraint(np.ones((1, n_assets)), -1.0, cosmo.ZeroSet)
    longonly = cosmo.Constraint(np.eye(n_assets), np.zeros(n_assets), cosmo.Nonnegatives)

    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6), device=device)
    gamma = 1.0
    model.assemble(2 * Sigma, -gamma * mu, [budget, longonly])
    returns = []
    for gamma in [0.5, 1.0, 2.0, 4.0]:
        model.update(q=-gamma * mu)
        res = model.optimize()
        assert res.status == "Solved"
        assert abs(res.x.sum() - 1.0) < 1e-4
        assert res.x.min() > -1e-5
        returns.append(mu @ res.x)
        print(f"gamma={gamma}: expected return {mu @ res.x:.4f}, "
              f"risk {res.x @ Sigma @ res.x:.4f}")

    # larger risk appetite -> larger expected return
    assert all(returns[i] <= returns[i + 1] + 1e-6 for i in range(len(returns) - 1))
    print("portfolio example OK")


if __name__ == "__main__":
    run(main, __doc__)
