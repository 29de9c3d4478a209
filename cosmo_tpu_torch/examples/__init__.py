"""The examples of ``examples/`` on cosmo_tpu_torch, each a module with
``main(device=None)``: it solves in float64 on a CUDA device unless given
``device="cpu"`` and asserts its own known answer.

    python -m cosmo_tpu_torch.examples.lp [--device cpu]
"""

# the example modules, one for each script of examples/
EXAMPLES = (
    "chordal_decomposition", "closest_correlation_matrix", "lasso",
    "logistic_regression", "lovasz_petersen", "lp", "max_eigenvalue", "maxcut",
    "portfolio_backtest", "portfolio_optimisation", "qp", "sum_abs_k_eigenvalues",
    "sum_of_squares", "svm_primal", "two_way_partitioning",
)
