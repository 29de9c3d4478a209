"""Portfolio backtest with model updates — the MPC-style re-solve loop
(reference: docs/src/literate/portfolio_model_updates.jl: assemble once,
then ``update!`` q/b and re-solve warm).

Each period t re-estimates the return vector mu_t from a rolling window and
re-solves

    min x' (Sigma + lam I) x - gamma mu_t' x + lam ||x - x_prev||^2
    s.t. 1'x = c_t  (budget, drifts with deposits),  x >= 0

Only the vectors change: q_t = -(gamma mu_t + 2 lam x_{t-1}) and the budget
row of b. ``model.update(q=, b=)`` keeps the assembled structure and the
device-resident P/A/cone maps (on a CUDA device also the scaling's CUDA
graph, which the first solve captures), and the previous solution
warm-starts the next solve — so every re-solve after the first skips
assembly, transfer and capture (the cached-path timing printed per period
demonstrates it).
"""
import time

import numpy as np

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch.examples._common import run, settings


def backtest(device=None):
    """The re-solve loop with its per-period assertions; returns the
    host-clock seconds of each period's solve."""
    rng = np.random.default_rng(11)
    n_assets = 30
    n_periods = 8
    gamma, lam = 1.0, 0.5

    F = rng.standard_normal((n_assets, 5))
    Sigma = F @ F.T / 12 + np.diag(rng.random(n_assets) * 0.08)
    # simulated return history the rolling estimates are drawn from
    true_mu = rng.random(n_assets) * 0.1
    history = true_mu + 0.05 * rng.standard_normal((40, n_assets))

    budget = cosmo.Constraint(np.ones((1, n_assets)), -1.0, cosmo.ZeroSet)
    longonly = cosmo.Constraint(np.eye(n_assets), np.zeros(n_assets),
                                cosmo.Nonnegatives)

    model = cosmo.Model(settings(eps_abs=1e-6, eps_rel=1e-6), device=device)
    x_prev = np.full(n_assets, 1.0 / n_assets)
    mu0 = history[:10].mean(axis=0)
    model.assemble(2 * (Sigma + lam * np.eye(n_assets)),
                   -(gamma * mu0 + 2 * lam * x_prev), [budget, longonly])

    times = []
    for t in range(n_periods):
        mu_t = history[: 10 + 4 * t].mean(axis=0)
        c_t = 1.0 + 0.02 * t                      # budget drifts with deposits
        q_t = -(gamma * mu_t + 2 * lam * x_prev)
        b_t = np.concatenate([[-c_t], np.zeros(n_assets)])
        model.update(q=q_t, b=b_t)
        model.warm_start(x0=x_prev)               # MPC warm start
        t0 = time.perf_counter()
        res = model.optimize()
        dt = time.perf_counter() - t0
        times.append(dt)
        assert res.status == "Solved", res.status
        assert abs(res.x.sum() - c_t) < 1e-4 * c_t
        assert res.x.min() > -1e-5
        x_prev = res.x
        print(f"t={t}: budget={c_t:.2f} ret={mu_t @ res.x:.4f} "
              f"iter={res.iter} solve={1e3 * dt:.1f} ms")
    return times


def main(device=None):
    times = backtest(device)
    # the cached path: solves after the first reuse the assembled structure,
    # the device-resident data and, on a CUDA device, the captured scaling
    print(f"first solve {1e3 * times[0]:.0f} ms, "
          f"median re-solve {1e3 * float(np.median(times[1:])):.0f} ms")
    assert min(times[1:]) < times[0]
    print("portfolio backtest example OK")


if __name__ == "__main__":
    run(main, __doc__)
