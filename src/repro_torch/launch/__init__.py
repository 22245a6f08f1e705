"""Entry points of the port: ``python -m repro_torch.launch.serve`` replays
a dynamic workload through the online serving runtime; ``mesh`` builds
the device meshes of the sharded engine over torch.distributed."""
from .mesh import Mesh, describe, make_host_mesh

__all__ = ["Mesh", "describe", "make_host_mesh"]
