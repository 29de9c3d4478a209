"""Constraints: A x + b in a convex set (reference: src/constraint.jl).

A constraint is ``A x + b in convex_set``.  ``dim`` / ``indices`` embed a
constraint on a sub-range of x into the full variable width
(reference: constraint.jl:64-70).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp

from . import cones as C


class Constraint:
    def __init__(
        self,
        A,
        b,
        convex_set: Union[C.ConvexSet, type],
        dim: int = 0,
        indices: Optional[Sequence[int]] = None,
    ):
        A = np.atleast_2d(np.asarray(A, dtype=np.float64)) if not sp.issparse(A) else A.tocsr()
        b = np.atleast_1d(np.asarray(b, dtype=np.float64)).ravel()
        rows = A.shape[0]
        if A.ndim == 2 and A.shape[0] == 1 and len(b) > 1 and A.shape[1] == len(b):
            # a 1-D A passed for a multi-row constraint: treat as column
            A = A.reshape(-1, 1)
            rows = A.shape[0]
        if rows != len(b):
            raise ValueError("The dimensions of matrix A and vector b don't match.")

        # allow passing the set as a type and instantiate at the right size
        if isinstance(convex_set, type):
            if issubclass(convex_set, (C.PowerCone, C.DualPowerCone)):
                raise ValueError(
                    f"Pass an instantiated object for {convex_set.__name__} (it needs alpha)."
                )
            if issubclass(convex_set, (C.PsdConeTriangle, C.DensePsdConeTriangle)):
                r = (int(np.sqrt(8 * rows + 1)) - 1) // 2
                if rows != 1 and r * (r + 1) // 2 != rows:
                    # reference deduces complex Hermitian storage here
                    # (constraint.jl:98-103)
                    convex_set = C.PsdConeTriangleComplex(rows)
                else:
                    convex_set = convex_set(rows)
            elif issubclass(convex_set, C.Box):
                raise ValueError("Pass an instantiated Box (it needs bounds).")
            else:
                convex_set = convex_set(rows)

        if convex_set.dim != rows:
            raise ValueError(
                "The row dimension of A doesn't match the dimension of the constraint set."
            )

        if indices is not None:
            idx = np.asarray(indices)
            if idx.min() < 0 or (dim and idx.max() >= dim):
                raise ValueError("indices out of range for the given dim")
            Ac = sp.lil_matrix((rows, dim))
            Ac[:, idx] = A
            A = Ac.tocsr()

        self.A = A
        self.b = b
        self.convex_set = convex_set

    @property
    def dim(self) -> int:
        return self.convex_set.dim

    def __repr__(self):
        shape = self.A.shape
        return f"Constraint\nSize of A: {shape}\nConvexSet: {type(self.convex_set).__name__}"
