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
