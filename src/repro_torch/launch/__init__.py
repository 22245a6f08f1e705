"""Entry points of the port: ``python -m repro_torch.launch.serve`` replays
a dynamic workload through the online serving runtime,
``python -m repro_torch.launch.train`` trains, and
``python -m repro_torch.launch.dryrun`` counts every registry cell for one
rank of the production meshes; ``mesh`` builds the device meshes (over
torch.distributed, or one rank's view of a larger one) and the sharding
specs."""
from .mesh import (Mesh, P, describe, make_host_mesh, make_production_mesh,
                   shard_shape)

__all__ = ["Mesh", "P", "describe", "make_host_mesh", "make_production_mesh",
           "shard_shape"]
