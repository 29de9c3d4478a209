"""Device-mesh sharding of the solve over ``torch.distributed`` (the port
of ``cosmo_tpu.parallel``): ``Model.optimize(mesh=make_mesh())`` on every
rank of a process group."""
from .mesh import (
    BLOCK_AXIS,
    make_mesh,
    shard_blockkkt,
    shard_cones,
    shard_coo,
    shard_problem,
    shard_vectors,
)

__all__ = [
    "BLOCK_AXIS",
    "make_mesh",
    "shard_blockkkt",
    "shard_cones",
    "shard_coo",
    "shard_problem",
    "shard_vectors",
]
