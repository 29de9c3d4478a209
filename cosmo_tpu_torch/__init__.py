"""cosmo_tpu_torch — the PyTorch/CUDA port of the cosmo_tpu conic ADMM solver.

It solves

    min  1/2 x'Px + q'x    s.t.  Ax + b in K

with the public surface of ``cosmo_tpu`` (``Model`` with its re-solves:
``update``, the warm starts, ``set_csc``; ``Settings``, ``Constraint``, the
cone classes, ``Result``, the clique merge strategies), on a CUDA device
unless the caller asks for the CPU (``Model(device="cpu")``). It takes
dense, block-dense or sparse input through the dense, block-diagonal or
matrix-free CG/MINRES KKT solve, with chordal decomposition of sparse PSD
constraints. The PSD projection of small blocks runs through a
hand-written CUDA Jacobi kernel (``ops/jacobi_proj.py``,
``csrc/jacobi_proj.cu``).

This package imports neither JAX nor ``cosmo_tpu``. What it does not port
yet (the exponential, power, custom and complex cones, custom KKT solvers,
mixed precision, the amortized and ``jacobi_mm`` backends, a device mesh,
and the printing entry points ``solve``, ``print_merge_logs`` and
``print_clique_sizes``) raises ``NotImplementedError`` naming the
ROADMAP.md item that will.
"""
from .models.cones import (
    Box,
    ConvexSet,
    CustomCone,
    DensePsdCone,
    DensePsdConeTriangle,
    DualExponentialCone,
    DualPowerCone,
    ExponentialCone,
    Nonnegatives,
    PowerCone,
    PsdCone,
    PsdConeTriangle,
    PsdConeTriangleColPad,
    PsdConeTriangleComplex,
    SecondOrderCone,
    ZeroSet,
)
from .chordal.merging import CliqueGraphMerge, MergeStrategy
from .models.constraint import Constraint
from .models.model import Model, assemble, optimize
from .ops.conedata import not_ported
from .results import Result, ResultInfo, ResultTimes
from .settings import CustomKKTSolver, Settings


def solve(*args, **kwargs):
    """The one-call SCS-style entry of ``cosmo_tpu``: not ported yet."""
    raise not_ported("cosmo_tpu_torch.solve", "printing")


def print_merge_logs(*args, **kwargs):
    """Not ported yet (``cosmo_tpu.utils.printing``)."""
    raise not_ported("cosmo_tpu_torch.print_merge_logs", "printing")


def print_clique_sizes(*args, **kwargs):
    """Not ported yet (``cosmo_tpu.utils.printing``)."""
    raise not_ported("cosmo_tpu_torch.print_clique_sizes", "printing")

__version__ = "0.1.0"

__all__ = [
    "Model",
    "Settings",
    "Constraint",
    "Result",
    "ResultInfo",
    "ResultTimes",
    "assemble",
    "optimize",
    "solve",
    "print_merge_logs",
    "print_clique_sizes",
    "CustomCone",
    "CustomKKTSolver",
    "MergeStrategy",
    "CliqueGraphMerge",
    "ZeroSet",
    "Nonnegatives",
    "Box",
    "SecondOrderCone",
    "PsdCone",
    "DensePsdCone",
    "PsdConeTriangle",
    "DensePsdConeTriangle",
    "PsdConeTriangleColPad",
    "PsdConeTriangleComplex",
    "ExponentialCone",
    "DualExponentialCone",
    "PowerCone",
    "DualPowerCone",
]
