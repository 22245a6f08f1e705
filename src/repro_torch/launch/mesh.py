"""Device meshes for the sharded engine, over torch.distributed.

The counterpart of the JAX package's ``launch/mesh.py``.  A ``Mesh``
names the axes of a grid of ranks, as the JAX meshes do
(``("data", "model")`` or ``("pod", "data", "model")``), holds this
rank's device and its coordinates, and provides the collectives that
``shard_map`` gave the JAX engine over a tuple of axes: ``all_gather``
(tiled: the pieces concatenated along one dimension in the axes'
row-major order), ``psum``, ``pmin`` and ``pmax``.

Over the ranks of an initialized process group a ``Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` (rank r at row-major
position r); a tuple of several axes is one group, the flattened
sub-mesh.  With no process group it is a one-device mesh whose
collectives are the identity, as on the JAX package's (1, 1, 1) mesh.
Which of the two it is is decided once, at construction.  An empty tuple
of axes is the identity on either.

``make_production_mesh`` (the TPU pod's 16 x 16 and 2 x 16 x 16) is not
ported here; its callers are the dry-run tools.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.device import resolve_device

Tensor = torch.Tensor
Axes = Tuple[str, ...]


class Mesh:
    """A grid of ranks with named axes; this rank's device and
    coordinates; collectives over tuples of axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} "
                             "must pair up, one distinct name an axis")
        if min(shape, default=1) < 1:
            raise ValueError(f"mesh axes must have size >= 1, got {shape}")
        self.axis_names: Axes = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = math.prod(shape)
        dev = resolve_device(device)
        self._groups: Dict[Axes, object] = {}
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(f"a mesh of {self.size} devices over a "
                                 f"process group of {world} ranks")
            if dev.type == "cuda":
                dev = torch.device(
                    "cuda", dist.get_rank() % torch.cuda.device_count())
                torch.cuda.set_device(dev)
            from torch.distributed.device_mesh import DeviceMesh
            self._dm: Optional[DeviceMesh] = DeviceMesh(
                dev.type, torch.arange(self.size).reshape(shape),
                mesh_dim_names=names)
            coords = tuple(self._dm.get_coordinate())
        else:
            if self.size != 1:
                raise ValueError(
                    f"a mesh of {self.size} devices needs an initialized "
                    f"process group of {self.size} ranks")
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._dm = None
            coords = (0,) * len(shape)
        self.device = dev
        self.coords: Dict[str, int] = dict(zip(names, coords))

    # ---- axes ----
    def _check(self, axes: Axes) -> Axes:
        axes = tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axes: Axes) -> int:
        """Devices along ``axes`` together (1 for an empty tuple)."""
        return math.prod(self.shape[a] for a in self._check(axes))

    def index(self, axes: Axes) -> int:
        """This rank's position along ``axes``, row-major in the order
        given: the slot of its piece in a tiled ``all_gather``."""
        pos = 0
        for a in self._check(axes):
            pos = pos * self.shape[a] + self.coords[a]
        return pos

    def group(self, axes: Axes):
        """The process group of this rank's peers along ``axes``, or None
        where the collective is the identity (no process group, or no
        axes).  Several axes must be named in mesh order; their group is
        the flattened sub-mesh.  Every rank makes the same calls in the
        same order, so groups are created collectively."""
        axes = self._check(axes)
        if self._dm is None or not axes:
            return None
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self._dm.get_group(axes[0])
            else:
                self._groups[axes] = self._dm[axes]._flatten().get_group()
        return self._groups[axes]

    # ---- collectives ----
    def all_gather(self, t: Tensor, axes: Axes, dim: int = 0) -> Tensor:
        """``t`` of every rank along ``axes``, concatenated along ``dim``
        in row-major order of the axes (``jax.lax.all_gather(...,
        tiled=True)``)."""
        g = self.group(axes)
        if g is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts, dim=dim)

    def _reduce(self, t: Tensor, axes: Axes, op) -> Tensor:
        g = self.group(axes)
        if g is None:
            return t
        out = t.clone()
        dist.all_reduce(out, op=op, group=g)
        return out

    def psum(self, t: Tensor, axes: Axes) -> Tensor:
        return self._reduce(t, axes, dist.ReduceOp.SUM)

    def pmin(self, t: Tensor, axes: Axes) -> Tensor:
        return self._reduce(t, axes, dist.ReduceOp.MIN)

    def pmax(self, t: Tensor, axes: Axes) -> Tensor:
        return self._reduce(t, axes, dist.ReduceOp.MAX)


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """A ``("data", "model")`` mesh over the ranks of the initialized
    process group (one device without one), ``model`` ranks a row."""
    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    if model < 1 or n % model:
        raise ValueError(f"{n} devices do not split into rows of {model}")
    return Mesh((n // model, model), ("data", "model"), device=device)


def describe(mesh: Mesh) -> str:
    return f"{mesh.shape} ({mesh.size} devices)"
