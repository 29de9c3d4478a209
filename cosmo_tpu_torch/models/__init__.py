from . import cones
from .constraint import Constraint
from .model import Model, assemble, optimize
