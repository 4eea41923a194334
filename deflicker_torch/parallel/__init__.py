from .mesh import (DATA_AXIS, Mesh, batch_sharding, data_axis_sharding,
                   launch, make_mesh, replicated, shard_constraint)
from .multihost import assign_videos, init_distributed, local_mesh

__all__ = ["DATA_AXIS", "make_mesh", "batch_sharding", "data_axis_sharding",
           "replicated", "shard_constraint", "assign_videos",
           "init_distributed", "local_mesh", "Mesh", "launch"]
