"""Synthetic benchmark / test problem generators (the part of
``cosmo_tpu.problems`` this package uses; the same seed gives the same
arrays).

They produce problems in the solver's internal form ``min 1/2 x'Px + q'x
s.t. Ax + s = b, s in K`` (the post-assembly convention of the reference,
src/interface.jl:478-484). The dual-form SDPs (maxcut, banded) are the
chordal decomposition's workloads.
"""
from __future__ import annotations

import numpy as np

from .models import cones as C


def tri_dim(r: int) -> int:
    return r * (r + 1) // 2


def block_sdp(n_blocks: int = 64, side: int = 16, n: int = 512, seed: int = 0,
              density: float = 0.05, dtype=np.float64):
    """A feasible block-diagonal SDP emulating a chordally decomposed problem.

    min 1/2||x||^2 + q'x  s.t.  A_i x + s_i = b_i,  s_i in PSDTriangle(side)
    for i = 1..n_blocks.  Each A_i is sparse (selector-like columns), and b_i
    is built so that a strictly feasible point exists.

    Returns (P, q, A, b, sets) with dense numpy arrays.
    """
    rng = np.random.default_rng(seed)
    d = tri_dim(side)
    m = n_blocks * d

    P = np.eye(n, dtype=dtype)
    q = rng.standard_normal(n).astype(dtype) * 0.1

    A = np.zeros((m, n), dtype=dtype)
    b = np.zeros(m, dtype=dtype)
    nnz_per_row = max(1, int(density * n))
    x_feas = rng.standard_normal(n).astype(dtype) * 0.1
    for blk in range(n_blocks):
        rows = slice(blk * d, (blk + 1) * d)
        cols = rng.choice(n, size=nnz_per_row, replace=False)
        Ablk = np.zeros((d, n), dtype=dtype)
        Ablk[:, cols] = rng.standard_normal((d, nnz_per_row)).astype(dtype)
        A[rows] = Ablk
        # b = A x_feas + svec(S) with S strictly PSD => s = b - A x is interior
        G = rng.standard_normal((side, side)).astype(dtype)
        S = G @ G.T / side + np.eye(side, dtype=dtype)
        b[rows] = Ablk @ x_feas + svec(S)

    sets = [C.PsdConeTriangle(d) for _ in range(n_blocks)]
    return P, q, A, b, sets


def _tri_rows_cols(r: int):
    """(i, j) index arrays of the upper triangle in svec (column-major) order."""
    j = np.repeat(np.arange(r), np.arange(1, r + 1))
    i = np.arange(tri_dim(r)) - tri_dim_vec(j)
    return i, j


def tri_dim_vec(j):
    return j * (j + 1) // 2


def svec(S: np.ndarray) -> np.ndarray:
    """Upper-triangle column-major packing with sqrt(2)-scaled off-diagonals
    (reference: src/convexset.jl:432-442)."""
    r = S.shape[0]
    i, j = _tri_rows_cols(r)
    scale = np.where(i == j, 1.0, np.sqrt(2.0)).astype(S.dtype)
    return S[i, j] * scale


def smat(v: np.ndarray) -> np.ndarray:
    """Inverse of :func:`svec`."""
    d = v.shape[0]
    r = (int(np.sqrt(8 * d + 1)) - 1) // 2
    i, j = _tri_rows_cols(r)
    vals = v * np.where(i == j, 1.0, 1.0 / np.sqrt(2.0)).astype(v.dtype)
    S = np.zeros((r, r), dtype=v.dtype)
    S[i, j] = vals
    S[j, i] = vals
    return S


def maxcut(n_nodes: int = 100, density: float = 0.1, seed: int = 0,
           dtype=np.float64, sparse: bool = False):
    """The maxcut SDP relaxation on a random weighted graph, in the
    *standard dual form* that exposes the aggregate sparsity pattern to
    chordal decomposition (BASELINE.md north-star workload):

        min 1'y   s.t.   diag(y) - L/4  >=  0            (PSD)

    (the dual of  max 1/4 <L, X>, X_ii = 1, X >= 0; equal optimal values).
    The aggregate sparsity of the PSD slack is the graph Laplacian pattern,
    which is what the decomposition splits into cliques.

    Returns (P, q, A, b, sets, L) with A in internal ``Ax + s = b`` form.
    """
    rng = np.random.default_rng(seed)
    if sparse or n_nodes > 3000:
        import scipy.sparse as sp

        # sample edges directly (O(#edges), not O(n^2))
        n_edges = int(density * n_nodes * (n_nodes - 1) / 2)
        i = rng.integers(0, n_nodes, size=int(n_edges * 1.2))
        j = rng.integers(0, n_nodes, size=int(n_edges * 1.2))
        keep = i < j
        i, j = i[keep], j[keep]
        uniq = np.unique(i.astype(np.int64) * n_nodes + j)[:n_edges]
        i, j = uniq // n_nodes, uniq % n_nodes
        wts = rng.random(i.size).astype(dtype)
        W = sp.coo_matrix((wts, (i, j)), shape=(n_nodes, n_nodes))
        W = (W + W.T).tocsr()
        deg = np.asarray(W.sum(axis=1)).ravel()
        Lap = (sp.diags(deg) - W).tocsr()
    else:
        W = np.triu(rng.random((n_nodes, n_nodes)) < density, 1).astype(dtype)
        W = W * rng.random((n_nodes, n_nodes)).astype(dtype)
        W = W + W.T
        Lap = np.diag(W.sum(1)) - W
    return _dual_form_sdp(Lap, dtype, sparse=sparse) + (Lap,)


def closest_correlation(n: int = 20, seed: int = 0, dtype=np.float64):
    """Closest correlation matrix (reference: examples/closest_correlation_matrix.jl):

        min 1/2 ||X - C||_F^2  s.t.  X_ii = 1, X >= 0.

    Returns (P, q, A, b, sets, Cmat).
    """
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)).astype(dtype)
    Cmat = 0.5 * (G + G.T)

    nvar = tri_dim(n)
    cvec = svec(Cmat)
    P = np.eye(nvar, dtype=dtype)
    q = -cvec

    diag_idx = [tri_dim(i + 1) - 1 for i in range(n)]
    A1 = np.zeros((n, nvar), dtype=dtype)
    for r, di in enumerate(diag_idx):
        A1[r, di] = 1.0
    b1 = np.ones(n, dtype=dtype)

    A2 = -np.eye(nvar, dtype=dtype)
    b2 = np.zeros(nvar, dtype=dtype)

    A = np.vstack([A1, A2])
    b = np.concatenate([b1, b2])
    sets = [C.ZeroSet(n), C.PsdConeTriangle(nvar)]
    return P, q, A, b, sets, Cmat


def banded_sdp(n_nodes: int = 200, bandwidth: int = 8, seed: int = 0,
               dtype=np.float64, sparse: bool = False):
    """A banded-sparsity dual-form SDP — the canonical chordal-decomposition
    showcase (reference docs/src/decomposition.md): the aggregate sparsity
    graph is banded and decomposes into ~n_nodes cliques of size
    bandwidth+1.  Same structure as :func:`maxcut` with a banded Laplacian.
    """
    rng = np.random.default_rng(seed)
    sparse = sparse or n_nodes > 1500   # dense A would be O(n^3/2) memory
    if sparse:
        import scipy.sparse as sp

        diags = []
        offs = []
        for k in range(1, bandwidth + 1):
            v = rng.random(n_nodes - k).astype(dtype)
            diags += [v, v]
            offs += [k, -k]
        Wb = sp.diags(diags, offs, shape=(n_nodes, n_nodes), format="csr")
        Lap = sp.diags(np.asarray(Wb.sum(axis=1)).ravel()) - Wb
    else:
        Wb = np.zeros((n_nodes, n_nodes), dtype=dtype)
        for k in range(1, bandwidth + 1):
            v = rng.random(n_nodes - k).astype(dtype)
            Wb += np.diag(v, k) + np.diag(v, -k)
        Lap = np.diag(Wb.sum(1)) - Wb
    return _dual_form_sdp(Lap, dtype, sparse=sparse) + (Lap,)


def _dual_form_sdp(Lap: np.ndarray, dtype, sparse: bool = False):
    """min 1'y s.t. diag(y) - Lap/4 in PSD, in internal ``Ay + s = b`` form:
    A[:, i] = -svec(E_ii), b = -svec(Lap)/4."""
    n_nodes = Lap.shape[0]
    nvar = n_nodes
    m = tri_dim(n_nodes)
    q = np.ones(nvar, dtype=dtype)
    diag_rows = np.array([tri_dim(i + 1) - 1 for i in range(n_nodes)])
    if sparse:
        import scipy.sparse as sp

        P = sp.csr_matrix((nvar, nvar), dtype=dtype)
        A = sp.csr_matrix(
            (-np.ones(n_nodes, dtype=dtype), (diag_rows, np.arange(n_nodes))),
            shape=(m, nvar),
        )
        Lc = sp.coo_matrix(Lap)
        mask = Lc.row <= Lc.col
        ii, jj, vv = Lc.row[mask], Lc.col[mask], Lc.data[mask]
        scale = np.where(ii == jj, 1.0, np.sqrt(2.0)).astype(dtype)
        b = np.zeros(m, dtype=dtype)
        b[jj.astype(np.int64) * (jj + 1) // 2 + ii] = -(vv * scale) / 4.0
    else:
        import scipy.sparse as sp

        if sp.issparse(Lap):
            Lap = np.asarray(Lap.todense())
        P = np.zeros((nvar, nvar), dtype=dtype)
        A = np.zeros((m, nvar), dtype=dtype)
        A[diag_rows, np.arange(n_nodes)] = -1.0
        b = -svec(Lap.astype(dtype)) / 4.0
    sets = [C.PsdConeTriangle(m)]
    return P, q, A, b, sets


def portfolio_data(k: int, seed: int = 0, n: int | None = None):
    """The factor model of the OSQP benchmark suite's portfolio problem
    (osqp_benchmarks, problem_classes/portfolio.py): n = 100 k assets
    unless given, a sparse n x k factor loading F (density 0.5, normal
    entries), the diagonal idiosyncratic risk D = rand(n) sqrt(k) and the
    normal expected returns mu. Returns (F as scipy CSR, diag(D), mu)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n = 100 * k if n is None else n
    F = sp.random(n, k, density=0.5, format="csr", random_state=rng,
                  data_rvs=rng.standard_normal)
    D = rng.random(n) * np.sqrt(k)
    mu = rng.standard_normal(n)
    return F, D, mu


def portfolio_q(mu: np.ndarray, k: int, gamma: float = 1.0) -> np.ndarray:
    """The linear cost [-mu / gamma; 0] of :func:`portfolio`."""
    return np.concatenate([-mu / gamma, np.zeros(k)])


def portfolio(k: int, gamma: float = 1.0, seed: int = 0, n: int | None = None):
    """min x'Dx + y'y - mu'x / gamma  s.t.  y = F'x, 1'x = 1, 0 <= x <= 1
    over [x; y] (osqp_benchmarks' portfolio QP), in internal ``Ax + s = b``
    form: a ZeroSet of k + 1 rows ([F', -I] and [1', 0]) and a Box of n
    rows (s = x in [0, 1]). Sparse and coupled: every x column meets the
    k factor rows. Returns (P, q, A, b, sets) with scipy CSR P and A."""
    import scipy.sparse as sp

    F, D, mu = portfolio_data(k, seed, n)
    n = F.shape[0]
    P = sp.block_diag((sp.diags(2.0 * D), 2.0 * sp.identity(k)), format="csr")
    A = sp.vstack([
        sp.hstack([F.T, -sp.identity(k)]),
        sp.hstack([sp.csr_matrix(np.ones((1, n))), sp.csr_matrix((1, k))]),
        sp.hstack([-sp.identity(n), sp.csr_matrix((n, k))]),
    ], format="csr")
    b = np.concatenate([np.zeros(k), [1.0], np.zeros(n)])
    sets = [C.ZeroSet(k + 1), C.Box(np.zeros(n), np.ones(n))]
    return P, portfolio_q(mu, k, gamma), A, b, sets


def portfolio_optimum(k: int, gamma: float = 1.0, seed: int = 0, n: int | None = None,
                      tol: float = 1e-13, max_iter: int = 100):
    """The optimum of :func:`portfolio` to ~1e-12, independent of the ADMM
    solver: a primal-dual interior-point method (Mehrotra's predictor and
    corrector) in float64 on the host over x alone (y = F'x eliminated):
    min x'(D + FF')x - mu'x / gamma s.t. 1'x = 1, 0 <= x <= 1. Each Newton
    system is diag + 2FF' and one equality, solved through the Woodbury
    identity with a k x k Cholesky factor. Returns (objective, x); raises
    if the complementarity gap does not fall below ``tol``."""
    F, D, mu = portfolio_data(k, seed, n)
    F = F.toarray()
    n = F.shape[0]
    c = -mu / gamma
    x = np.full(n, 1.0 / n)
    z = np.ones(n)           # multipliers of x >= 0
    w = np.ones(n)           # multipliers of x <= 1
    nu = 0.0                 # multiplier of 1'x = 1

    def newton(rd, rp, rz, rw, x, z, w):
        """(dx, dnu, dz, dw) for the linearized KKT conditions with right
        sides -rd, -rp, -rz, -rw."""
        u = 1.0 - x
        delta = 2.0 * D + z / x + w / u
        fd = F / delta[:, None]
        chol = np.linalg.cholesky(0.5 * np.eye(k) + F.T @ fd)

        def minv(v):
            t = np.linalg.solve(chol.T, np.linalg.solve(chol, F.T @ (v / delta)))
            return v / delta - fd @ t

        r1 = -rd - rz / x + rw / u
        m1, ma = minv(r1), minv(np.ones(n))
        dnu = (-rp - m1.sum()) / ma.sum()
        dx = m1 + dnu * ma
        return dx, dnu, -(rz + z * dx) / x, (-rw + w * dx) / u

    def step(v, dv):
        neg = dv < 0
        return min(1.0, np.min(-v[neg] / dv[neg])) if neg.any() else 1.0

    for _ in range(max_iter):
        u = 1.0 - x
        hx = 2.0 * D * x + 2.0 * F @ (F.T @ x)
        rd = hx + c - nu - z + w
        rp = x.sum() - 1.0
        mu_gap = (z @ x + w @ u) / (2 * n)
        if mu_gap < tol and np.abs(rd).max() < tol * 1e3 and abs(rp) < 1e-10:
            return float(0.5 * x @ hx + c @ x), x
        # predictor (affine scaling), then the centred corrector
        ax, _, az, aw = newton(rd, rp, z * x, w * u, x, z, w)
        a_p = min(step(x, ax), step(u, -ax))
        a_d = min(step(z, az), step(w, aw))
        mu_aff = ((z + a_d * az) @ (x + a_p * ax)
                  + (w + a_d * aw) @ (u - a_p * ax)) / (2 * n)
        sigma = (mu_aff / mu_gap) ** 3
        dx, dnu, dz, dw = newton(rd, rp, z * x + ax * az - sigma * mu_gap,
                                 w * u - ax * aw - sigma * mu_gap, x, z, w)
        a_p = 0.99 * min(step(x, dx), step(u, -dx))
        a_d = 0.99 * min(step(z, dz), step(w, dw))
        x = x + a_p * dx
        nu, z, w = nu + a_d * dnu, z + a_d * dz, w + a_d * dw
    raise RuntimeError(f"portfolio_optimum: no convergence in {max_iter} iterations")


def logistic_data(n_samples: int, n_features: int, nnz_per_sample=None, seed: int = 0):
    """Features Z [N, d] and labels y in {-1, 1} for
    :func:`logistic_regression`. ``nnz_per_sample`` None: Gaussian Z, a
    Gaussian w_true and y = sign(Z w_true + 0.3 noise), drawn as
    ``examples/logistic_regression.py`` draws them (seed 3 there). Else a
    LIBSVM-style binary Z (scipy CSR) with that many features set to 1 in
    each row, chosen uniformly (a9a: 123 features, 13.9 set on average), and
    the labels drawn the same way."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    N, d = n_samples, n_features
    if nnz_per_sample is None:
        Z = rng.standard_normal((N, d))
    else:
        k = int(nnz_per_sample)
        cols = np.argsort(rng.random((N, d)), axis=1)[:, :k]
        Z = sp.csr_matrix((np.ones(N * k), (np.repeat(np.arange(N), k), cols.ravel())),
                          shape=(N, d))
    w_true = rng.standard_normal(d)
    y = np.sign(Z @ w_true + 0.3 * rng.standard_normal(N))
    return Z, y


def logistic_regression(n_samples: int, n_features: int, nnz_per_sample=None,
                        lam: float = 0.1, seed: int = 0):
    """L2-regularised logistic regression through exponential cones, the
    model of ``examples/logistic_regression.py`` (reference:
    examples/logistic_regression.jl):

        min sum_i log(1 + exp(-y_i z_i'w)) + lam ||w||^2

    over x = [w (d); t (N); v (N); u (N)]: each softplus term
    log(1 + exp(a_i)) <= t_i (a_i = -y_i z_i'w) is the pair
    (a_i - t_i, 1, u_i) and (-t_i, 1, v_i) in K_exp with u_i + v_i <= 1.
    In the internal ``Ax + s = b`` form, rows in the order that
    ``Model.assemble`` gives the example's constraints: the N rows of
    u_i + v_i <= 1 (Nonnegatives), then each sample's two exponential
    cones. ``A`` is scipy CSR (P too). Returns (P, q, A, b, sets, (Z, y)),
    with Z from :func:`logistic_data`."""
    import scipy.sparse as sp

    Z, y = logistic_data(n_samples, n_features, nnz_per_sample, seed)
    N, d = n_samples, n_features
    n = d + 3 * N
    t0, v0, u0 = d, d + N, d + 2 * N
    P = sp.csr_matrix((np.full(d, 2.0 * lam), (np.arange(d), np.arange(d))), shape=(n, n))
    q = np.concatenate([np.zeros(d), np.ones(N), np.zeros(2 * N)])
    i = np.arange(N)
    # the rows of A (s = b - A x); the Nonnegatives rows first
    Zc = sp.coo_matrix(Z)
    e1 = N + 6 * i                     # the first cone's rows of sample i
    rows = [i, i,                      # s_i = 1 - v_i - u_i
            e1[Zc.row], e1, e1 + 2,    # (a_i - t_i, 1, u_i): -A = [-y_i z_i, -1]
            e1 + 3, e1 + 5]            # (-t_i, 1, v_i)
    cols = [v0 + i, u0 + i, Zc.col, t0 + i, u0 + i, t0 + i, v0 + i]
    vals = [np.ones(N), np.ones(N), y[Zc.row] * Zc.data, np.ones(N), -np.ones(N),
            np.ones(N), -np.ones(N)]
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(7 * N, n))
    b = np.zeros(7 * N)
    b[:N] = 1.0
    b[e1 + 1] = 1.0
    b[e1 + 4] = 1.0
    sets = [C.Nonnegatives(N)] + [C.ExponentialCone() for _ in range(2 * N)]
    return P, q, A, b, sets, (Z, y)


def logistic_loss(Z, y, lam: float, w):
    """sum_i log(1 + exp(-y_i z_i'w)) + lam ||w||^2 and its gradient, in
    float64 on the host."""
    margin = y * (Z @ w)
    loss = float(np.sum(np.logaddexp(0.0, -margin)) + lam * w @ w)
    sig = 0.5 * (1.0 - np.tanh(0.5 * margin))          # 1 / (1 + exp(margin))
    grad = -(Z.T @ (y * sig)) + 2.0 * lam * w
    return loss, np.asarray(grad).ravel()


def logistic_optimum(Z, y, lam: float, gtol: float = 1e-10, max_iter: int = 100):
    """The unconstrained float64 minimum of :func:`logistic_loss` on the
    host, independent of the ADMM solver: Newton's method with a
    backtracking line search, to a gradient of ``gtol`` (max norm).
    Returns (loss, w); raises if it does not get there."""
    import scipy.sparse as sp

    d = Z.shape[1]
    w = np.zeros(d)
    loss, g = logistic_loss(Z, y, lam, w)
    for _ in range(max_iter):
        if np.abs(g).max() <= gtol:
            return loss, w
        margin = y * (Z @ w)
        sig = 0.5 * (1.0 - np.tanh(0.5 * margin))
        weights = sig * (1.0 - sig)
        H = Z.T @ (Z.multiply(weights[:, None]) if sp.issparse(Z) else Z * weights[:, None])
        H = (H.toarray() if sp.issparse(H) else H) + 2.0 * lam * np.eye(d)
        step = np.linalg.solve(H, -g)
        a = 1.0
        while True:
            new_loss, new_g = logistic_loss(Z, y, lam, w + a * step)
            if new_loss <= loss + 1e-4 * a * (g @ step) or a < 1e-10:
                break
            a *= 0.5
        w, loss, g = w + a * step, new_loss, new_g
    raise RuntimeError(f"logistic_optimum: gradient {np.abs(g).max():.2e} after "
                       f"{max_iter} Newton steps")
