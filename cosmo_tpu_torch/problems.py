"""Synthetic benchmark / test problem generators (the part of
``cosmo_tpu.problems`` this package uses; the same seed gives the same
arrays).

They produce problems in the solver's internal form ``min 1/2 x'Px + q'x
s.t. Ax + s = b, s in K`` (the post-assembly convention of the reference,
src/interface.jl:478-484). The decomposition workloads (maxcut, banded,
closest correlation) come with the chordal path.
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
