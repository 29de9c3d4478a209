"""Device operations of the solve: linear operators, cone data and
projections, scaling, KKT solves, residuals and certificates."""
