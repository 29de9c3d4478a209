"""cosmo_tpu_torch — the PyTorch/CUDA port of the cosmo_tpu conic ADMM solver.

It solves

    min  1/2 x'Px + q'x    s.t.  Ax + b in K

with the public surface of ``cosmo_tpu`` (``Model``, ``Settings``,
``Constraint``, the cone classes, ``Result``), on a CUDA device unless the
caller asks for the CPU (``Model(device="cpu")``). The PSD projection of
small blocks runs through a hand-written CUDA Jacobi kernel
(``ops/jacobi_proj.py``, ``csrc/jacobi_proj.cu``).

This package imports neither JAX nor ``cosmo_tpu``. What it does not port
yet raises ``NotImplementedError`` naming the ROADMAP.md item that will.
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
from .models.constraint import Constraint
from .models.model import Model, assemble, optimize
from .results import Result, ResultInfo, ResultTimes
from .settings import CustomKKTSolver, Settings

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
    "CustomCone",
    "CustomKKTSolver",
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
