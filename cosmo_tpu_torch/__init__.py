"""cosmo_tpu_torch — the PyTorch/CUDA port of the cosmo_tpu conic ADMM solver.

It solves

    min  1/2 x'Px + q'x    s.t.  Ax + b in K

with the public surface of ``cosmo_tpu`` (``Model`` with its re-solves:
``update``, the warm starts, ``set_csc``; the one-call ``solve``;
``Settings``, ``Constraint``, the cone classes, custom cones and KKT
solvers, ``Result``, the clique merge strategies, the printing functions;
the CVXPY adapter in :mod:`.cvxpy_solver`), on a CUDA device unless the
caller asks for the CPU (``Model(device="cpu")``, ``solve(...,
device="cpu")``). K is any product of the zero, nonnegative, box,
second-order, PSD (real or complex Hermitian), exponential and power cones
and their duals, and user-defined cones. It takes dense, block-dense or
sparse input through the dense, block-diagonal or matrix-free CG/MINRES
KKT solve, with chordal decomposition of sparse PSD constraints. Hand-written
CUDA kernels carry the projections: the Jacobi PSD projection of small
blocks (``ops/jacobi_proj.py``, ``csrc/jacobi_proj.cu``), its warm-started
variant for the amortized backend, which carries each PSD bucket's
eigenbasis across iterations (``ops/jacobi_eig.py``,
``csrc/jacobi_eig.cu``), and the exponential and power cones'
(``ops/exp_pow_proj.py``, ``csrc/exp_pow_proj.cu``). The examples of the
JAX package have their port in :mod:`.examples`
(``python -m cosmo_tpu_torch.examples.lp [--device cpu]``).

A solve runs SPMD over ``torch.distributed`` through a device mesh
(:mod:`.parallel`: ``Model.optimize(mesh=make_mesh())`` on every rank of a
gloo or NCCL group).

This package imports neither JAX nor ``cosmo_tpu``. What it does not port
yet (on a CUDA device the amortized backend above side 48) raises
``NotImplementedError`` naming the ROADMAP.md item that will.
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
from .interface import solve
from .models.model import Model, assemble, optimize
from .results import Result, ResultInfo, ResultTimes
from .settings import CustomKKTSolver, Settings
from .utils.printing import print_clique_sizes, print_merge_logs

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
