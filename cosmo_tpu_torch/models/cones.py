"""User-facing convex set / cone descriptions (host side).

These mirror the reference cone types (src/convexset.jl) but carry no solver
state: they are pure descriptions.  At solve time the ordered list of cones is
compiled into type-grouped, padded, batched device arrays
(:mod:`cosmo_tpu_torch.ops.conedata`), replacing the reference's per-cone dynamic
dispatch (src/convexset.jl:885-891) with a handful of fused vectorized ops.
"""
from __future__ import annotations

import dataclasses
import numpy as np


class ConvexSet:
    """Base class for convex set descriptions."""

    dim: int

    def __repr__(self):
        return f"{type(self).__name__}(dim={self.dim})"


@dataclasses.dataclass(repr=False)
class ZeroSet(ConvexSet):
    """The zero set {0}^dim (reference: src/convexset.jl:16-41)."""

    dim: int

    def __post_init__(self):
        if self.dim < 0:
            raise ValueError("dimension must be nonnegative")


@dataclasses.dataclass(repr=False)
class Nonnegatives(ConvexSet):
    """The nonnegative orthant (reference: src/convexset.jl:52-82)."""

    dim: int

    def __post_init__(self):
        if self.dim < 0:
            raise ValueError("dimension must be nonnegative")


@dataclasses.dataclass(repr=False)
class Box(ConvexSet):
    """Box/interval set {x : l <= x <= u} (reference: src/convexset.jl:803-871)."""

    l: np.ndarray
    u: np.ndarray

    def __post_init__(self):
        self.l = np.atleast_1d(np.asarray(self.l, dtype=np.float64))
        self.u = np.atleast_1d(np.asarray(self.u, dtype=np.float64))
        if self.l.shape != self.u.shape:
            raise ValueError("bounds must be same length")
        bad = self.l > self.u
        if np.any(bad):
            i = int(np.argmax(bad))
            raise ValueError(
                f"Box set: inconsistent lower/upper bounds at index {i}: "
                f"l[i]={self.l[i]}, u[i]={self.u[i]}"
            )

    @property
    def dim(self) -> int:
        return len(self.l)

    @classmethod
    def free(cls, dim: int) -> "Box":
        return cls(np.full(dim, -np.inf), np.full(dim, np.inf))


@dataclasses.dataclass(repr=False)
class SecondOrderCone(ConvexSet):
    """Second-order (Lorentz) cone {(t, x) : ||x||_2 <= t}
    (reference: src/convexset.jl:92-122)."""

    dim: int

    def __post_init__(self):
        if self.dim < 1:
            raise ValueError("dimension must be >= 1")


@dataclasses.dataclass(repr=False)
class PsdCone(ConvexSet):
    """PSD cone, square (column-stacked) storage; dim = r*r
    (reference: src/convexset.jl:271-285)."""

    dim: int
    decomposable: bool = True   # False == the reference's DensePsdCone

    def __post_init__(self):
        r = int(np.sqrt(self.dim))
        if r * r != self.dim:
            raise ValueError("dimension must be a square")
        self.side = r


@dataclasses.dataclass(repr=False)
class DensePsdCone(PsdCone):
    """PSD cone exempt from chordal decomposition
    (reference: src/convexset.jl:288-299)."""

    decomposable: bool = False


@dataclasses.dataclass(repr=False)
class PsdConeTriangle(ConvexSet):
    """Real PSD cone, svec (upper-triangle, sqrt(2)-scaled off-diagonals)
    storage; dim = r(r+1)/2 (reference: src/convexset.jl:362-379)."""

    dim: int
    decomposable: bool = True

    def __post_init__(self):
        r = (int(np.sqrt(8 * self.dim + 1)) - 1) // 2
        if r * (r + 1) // 2 != self.dim:
            raise ValueError("dimension must be a triangle number")
        self.side = r


@dataclasses.dataclass(repr=False)
class DensePsdConeTriangle(PsdConeTriangle):
    """Triangle PSD cone exempt from decomposition
    (reference: src/convexset.jl:383-394)."""

    decomposable: bool = False


@dataclasses.dataclass(repr=False)
class PsdConeTriangleColPad(ConvexSet):
    """Real PSD cone in COLUMN-PADDED svec storage: entry (i, j) of the
    r x r matrix, i <= j, lives at offset j*r + i; the strictly-lower slots
    (i > j) are structural zeros. dim = r*r. Off-diagonals carry the same
    sqrt(2) svec scaling as :class:`PsdConeTriangle` — the represented set
    is identical, only the memory layout differs.

    Internal to the chordal compact transform (chordal/transform.py), which
    emits it for giant clique blocks: with a constant column stride the
    projection's tri<->full conversion is a pure reshape+mask instead of an
    r-slice gather plus a tri-index gather (measured on v5e at r = 896:
    3.70 ms -> 0.018 ms per iteration — XLA TPU's gather engine runs at
    ~6.6 ns/element while reshape+mask is plain HBM bandwidth). The extra
    r(r-1)/2 pad slots get zero A-rows and b = 0 from the transform, so
    they are exactly 0 along the whole ADMM trajectory and ride the (free)
    fused elementwise vector path. Reference storage analog: svec,
    convexset.jl:362-379.
    """

    dim: int
    decomposable: bool = False

    def __post_init__(self):
        r = int(np.sqrt(self.dim))
        if r * r != self.dim:
            raise ValueError("dimension must be a square (r^2 padded entries)")
        self.side = r


@dataclasses.dataclass(repr=False)
class PsdConeTriangleComplex(ConvexSet):
    """Complex Hermitian PSD cone in packed-triangle storage; dim = r^2.

    Storage layout matches the reference (src/convexset.jl:344-360): the
    r(r+1)/2 leading entries are the real parts of the upper triangle
    (sqrt(2)-scaled off-diagonals), followed by the r(r-1)/2 imaginary parts
    of the strict upper triangle (sqrt(2)-scaled).
    """

    dim: int
    decomposable: bool = False

    def __post_init__(self):
        r = int(np.sqrt(self.dim))
        if r * r != self.dim:
            raise ValueError("dimension must be a square (r^2 packed entries)")
        self.side = r


@dataclasses.dataclass(repr=False)
class ExponentialCone(ConvexSet):
    """K_exp = cl{(x,y,z) : y>0, y e^{x/y} <= z}
    (reference: src/convexset.jl:497-618)."""

    max_iter: int = 100
    tol: float = 1e-8
    dim: int = 3


@dataclasses.dataclass(repr=False)
class DualExponentialCone(ConvexSet):
    """Dual exponential cone (reference: src/convexset.jl:750-759)."""

    max_iter: int = 100
    tol: float = 1e-8
    dim: int = 3


@dataclasses.dataclass(repr=False)
class PowerCone(ConvexSet):
    """3-d power cone {(x,y,z) : x^a y^(1-a) >= |z|, x,y >= 0}
    (reference: src/convexset.jl:626-742)."""

    alpha: float
    max_iter: int = 20
    tol: float = 1e-8
    dim: int = 3

    def __post_init__(self):
        if not (0.0 < self.alpha < 1.0):
            raise ValueError("The exponent alpha of the power cone has to be in (0, 1).")


@dataclasses.dataclass(repr=False)
class DualPowerCone(ConvexSet):
    """3-d dual power cone (reference: src/convexset.jl:766-776)."""

    alpha: float
    max_iter: int = 20
    tol: float = 1e-8
    dim: int = 3

    def __post_init__(self):
        if not (0.0 < self.alpha < 1.0):
            raise ValueError("The exponent alpha of the dual power cone has to be in (0, 1).")


@dataclasses.dataclass(repr=False, eq=False)  # identity hash: the cone is
# static jit-cache data; two distinct instances are distinct programs
class CustomCone(ConvexSet):
    """User-defined convex set (reference: the
    AbstractConvexSet extension interface, docs/src/lin_solver.md /
    src/projections.jl:4-20).

    ``project``: ``f(v: [dim]) -> [dim]`` projecting onto the set.
    Optional ``in_dual(v, tol) -> bool`` and ``in_pol_recc(v, tol) -> bool``
    membership tests and ``support(v, tol) -> float`` support function feed
    the infeasibility certificates; without them the solver stays correct
    but conservatively never certifies infeasibility through this cone.
    ``scalar_scaling``: rectify Ruiz row scalings to one scalar (required
    unless the set is separable per-coordinate).
    """

    dim: int
    project: object = None
    in_dual: object = None
    in_pol_recc: object = None
    support: object = None
    scalar_scaling: bool = True

    def __post_init__(self):
        if self.dim < 1:
            raise ValueError("dimension must be >= 1")
        if self.project is None:
            raise ValueError("CustomCone needs a project function")


# Canonical ordering of sets inside the stacked constraint matrix
# (reference: src/interface.jl:466-475).
def sort_key(C: ConvexSet) -> int:
    if isinstance(C, ZeroSet):
        return 1
    if isinstance(C, Nonnegatives):
        return 2
    if isinstance(C, Box):
        return 3
    if isinstance(C, SecondOrderCone):
        return 4
    if isinstance(C, PsdCone):
        return 5
    return 6


# Cones whose Ruiz row-scaling must be rectified to a single scalar
# (reference: src/convexset.jl:953-958).
def needs_scalar_scaling(C: ConvexSet) -> bool:
    if isinstance(C, CustomCone):
        return C.scalar_scaling
    return isinstance(
        C,
        (
            SecondOrderCone,
            PsdCone,
            PsdConeTriangle,
            PsdConeTriangleColPad,
            PsdConeTriangleComplex,
            ExponentialCone,
            DualExponentialCone,
            PowerCone,
            DualPowerCone,
        ),
    )
