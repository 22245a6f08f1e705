"""Device meshes over torch.distributed, and sharding specs.

The counterpart of the JAX package's ``launch/mesh.py``.  A ``Mesh``
names the axes of a grid of ranks, as the JAX meshes do
(``("data", "model")`` or ``("pod", "data", "model")``), holds this
rank's device and its coordinates, and provides the collectives that
``shard_map`` gave the JAX package over a tuple of axes: ``all_gather``
(tiled: the pieces concatenated along one dimension in the axes'
row-major order), ``psum``, ``psum_scatter``, ``pmin`` and ``pmax``, and
``pvary`` (the identity, whose backward is a ``psum``).

A ``Mesh`` is one of three kinds, decided once, at construction:

- over the ranks of an initialized process group it is a
  ``torch.distributed.device_mesh.DeviceMesh`` (rank r at row-major
  position r); a tuple of several axes is one group, the flattened
  sub-mesh;
- with no process group and no ``rank`` it is a one-device mesh whose
  collectives are the identity, as on the JAX package's (1, 1, 1) mesh;
- with a ``rank`` it is abstract: one rank's view of a mesh of any size
  with no process group (``make_production_mesh``).  Its collectives
  return tensors of the right shape on the mesh's device (``meta`` by
  default), made of copies of the rank's own piece: only their shape,
  memory and time mean anything.

Inside ``with mesh.recording():`` (which ``roofline.count.count_call``
enters) every collective over a group of more than one rank is recorded
in ``Mesh.records`` with its kind, axes, group size, buffer bytes and wire
bytes by the ring formulas of the reference's ``parse_collectives``
(all-gather and reduce-scatter (n-1)/n of the full buffer, all-reduce
2(n-1)/n), and whether the forward or the backward made it.  The
differentiable collectives' backward calls the conjugate collective
through the same mesh: all-gather <-> reduce-scatter, ``psum`` (the
Megatron "g" op: its backward is the identity) <-> ``pvary`` (the "f"
op: the identity, whose backward is an all-reduce).  An all-gather whose
output feeds a computation replicated over the axes takes
``invariant=True``: its backward keeps the rank's own slice.  An empty
tuple of axes is the identity on every kind.

``P`` is the port's ``PartitionSpec`` and ``shard_shape`` splits a shape
by it as ``NamedSharding.shard_shape`` does (each sharded dimension must
divide evenly).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.device import resolve_device

Tensor = torch.Tensor
Axes = Tuple[str, ...]
Entry = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry a dimension, each ``None``
    (replicated), an axis name or a tuple of axis names (the dimension
    split over their product, the first the major).  Trailing
    dimensions past the entries are replicated."""

    def __new__(cls, *entries: Entry):
        norm = []
        for e in entries:
            if isinstance(e, (list, tuple)):
                e = tuple(e) if e else None
            elif e is not None and not isinstance(e, str):
                raise TypeError(f"a spec entry is None, an axis name or a "
                                f"tuple of names, got {e!r}")
            norm.append(e)
        return super().__new__(cls, norm)

    def axes(self, dim: int) -> Axes:
        """The axes dimension ``dim`` is split over (empty: replicated)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    def all_axes(self) -> Axes:
        """Every axis the spec splits some dimension over, in order."""
        return tuple(a for i in range(len(self)) for a in self.axes(i))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def shard_shape(shape: Sequence[int], spec: P, mesh: "Mesh"
                ) -> Tuple[int, ...]:
    """The local shape of an array of ``shape`` laid out by ``spec`` on
    ``mesh``; a dimension that the product of its axes does not divide
    raises ValueError, as ``NamedSharding.shard_shape`` does."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)} has dimensions")
    out = []
    for i, n in enumerate(shape):
        k = mesh.axis_size(spec.axes(i))
        if n % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} (size {n}) "
                             f"does not split evenly {k} ways by {spec}")
        out.append(n // k)
    return tuple(out)


def _frac(n: int) -> float:
    return (n - 1) / n


class Mesh:
    """A grid of ranks with named axes; this rank's device and
    coordinates; collectives over tuples of axes, recorded."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda", *, rank: Optional[int] = None):
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
        self.abstract = rank is not None
        self.records: List[dict] = []
        self._recording = 0             # depth of ``recording()``
        self.notes: List[str] = []      # what a count could not see
        self._backward = 0
        dev = resolve_device(device)
        self._groups: Dict[Axes, object] = {}
        self._dm = None
        if self.abstract:
            if not 0 <= rank < self.size:
                raise ValueError(f"rank {rank} is not in a mesh of "
                                 f"{self.size} ranks")
            coords, r = [], rank
            for s in reversed(shape):
                coords.append(r % s)
                r //= s
            coords = tuple(reversed(coords))
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(f"a mesh of {self.size} devices over a "
                                 f"process group of {world} ranks")
            if dev.type == "cuda":
                dev = torch.device(
                    "cuda", dist.get_rank() % torch.cuda.device_count())
                torch.cuda.set_device(dev)
            from torch.distributed.device_mesh import DeviceMesh
            self._dm = DeviceMesh(
                dev.type, torch.arange(self.size).reshape(shape),
                mesh_dim_names=names)
            coords = tuple(self._dm.get_coordinate())
        else:
            if self.size != 1:
                raise ValueError(
                    f"a mesh of {self.size} devices needs an initialized "
                    f"process group of {self.size} ranks, or a rank for "
                    f"an abstract mesh")
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
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

    def present(self, axes: Axes) -> Axes:
        """The axes of ``axes`` that this mesh has, in order."""
        return tuple(a for a in axes if a in self.shape)

    def group(self, axes: Axes):
        """The process group of this rank's peers along ``axes``, or None
        where there is none (no process group, or no axes).  Several axes
        must be named in mesh order; their group is the flattened
        sub-mesh.  Every rank makes the same calls in the same order, so
        groups are created collectively."""
        axes = self._check(axes)
        if self._dm is None or not axes:
            return None
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self._dm.get_group(axes[0])
            else:
                self._groups[axes] = self._dm[axes]._flatten().get_group()
        return self._groups[axes]

    # ---- the record ----
    @contextlib.contextmanager
    def recording(self):
        """Record the collectives made inside the context, after the
        records so far are cleared; outside it nothing is recorded."""
        self.records = []
        self._recording += 1
        try:
            yield self.records
        finally:
            self._recording -= 1

    def _record(self, kind: str, axes: Axes, n: int, nbytes: int,
                wire: float, shape: tuple, dtype) -> None:
        """One record: ``shape`` and ``dtype`` are the collective's
        result's (the whole gathered tensor, the scattered piece)."""
        if not self._recording:
            return
        self.records.append({
            "kind": kind, "axes": axes, "n": n, "bytes": int(nbytes),
            "wire_bytes": float(wire), "shape": tuple(shape),
            "dtype": str(dtype).replace("torch.", ""),
            "pass": "backward" if self._backward else "forward"})

    def collective_totals(self) -> dict:
        """{"ops", "wire_bytes", "by_kind": {kind: wire bytes}} of the
        records."""
        by: Dict[str, float] = {}
        for r in self.records:
            by[r["kind"]] = by.get(r["kind"], 0.0) + r["wire_bytes"]
        return {"ops": len(self.records),
                "wire_bytes": float(sum(by.values())), "by_kind": by}

    # ---- the primitives: record, then compute by kind ----
    def _ag(self, t: Tensor, axes: Axes, dim: int) -> Tensor:
        n = self.axis_size(axes)
        if n == 1:
            return t
        full = t.numel() * t.element_size() * n
        shape = list(t.shape)
        shape[dim] *= n
        self._record("all-gather", axes, n, full, full * _frac(n), shape,
                     t.dtype)
        g = self.group(axes)
        if g is None:
            return torch.cat([t] * n, dim=dim)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=g)
        return torch.cat(parts, dim=dim)

    def _ar(self, t: Tensor, axes: Axes, op: str) -> Tensor:
        n = self.axis_size(axes)
        if n == 1:
            return t
        nbytes = t.numel() * t.element_size()
        self._record("all-reduce", axes, n, nbytes, 2 * nbytes * _frac(n),
                     t.shape, t.dtype)
        out = t.clone()
        g = self.group(axes)
        if g is not None:
            dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=g)
        return out

    def _rs(self, t: Tensor, axes: Axes, dim: int) -> Tensor:
        n = self.axis_size(axes)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways")
        nbytes = t.numel() * t.element_size()
        size = t.shape[dim] // n
        shape = list(t.shape)
        shape[dim] = size
        self._record("reduce-scatter", axes, n, nbytes, nbytes * _frac(n),
                     shape, t.dtype)
        g = self.group(axes)
        if g is None:
            return t.narrow(dim, self.index(axes) * size, size).clone()
        if dist.get_backend(g) == "nccl":
            inp = t.movedim(dim, 0).contiguous()
            out = inp.new_empty((size,) + inp.shape[1:])
            dist.reduce_scatter_tensor(out, inp, group=g)
            return out.movedim(0, dim).contiguous()
        full = t.contiguous().clone()          # gloo: all-reduce, then keep
        dist.all_reduce(full, group=g)         # this rank's piece
        return full.narrow(dim, self.index(axes) * size, size).clone()

    # ---- the collectives ----
    def all_gather(self, t: Tensor, axes: Axes, dim: int = 0,
                   invariant: bool = False) -> Tensor:
        """``t`` of every rank along ``axes``, concatenated along ``dim``
        in row-major order of the axes (``jax.lax.all_gather(...,
        tiled=True)``).  Backward: a reduce-scatter, or with
        ``invariant`` (the output feeds a computation replicated over the
        axes) the rank's own slice."""
        axes = self._check(axes)
        if self.axis_size(axes) == 1:
            return t
        return _AllGather.apply(t, self, axes, dim % t.dim(), invariant)

    def psum_scatter(self, t: Tensor, axes: Axes, dim: int = 0) -> Tensor:
        """The sum over ``axes`` of ``t``, of which this rank keeps its
        slice along ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``).
        Backward: an all-gather."""
        axes = self._check(axes)
        if self.axis_size(axes) == 1:
            return t
        return _ReduceScatter.apply(t, self, axes, dim % t.dim())

    def psum(self, t: Tensor, axes: Axes) -> Tensor:
        """The sum over ``axes``.  Backward: the identity (the output is
        replicated over the axes)."""
        axes = self._check(axes)
        if self.axis_size(axes) == 1:
            return t
        return _Psum.apply(t, self, axes)

    def pvary(self, t: Tensor, axes: Axes) -> Tensor:
        """The identity where a tensor replicated over ``axes`` enters a
        computation that differs along them.  Backward: a ``psum``."""
        axes = self._check(axes)
        if self.axis_size(axes) == 1 or not t.requires_grad:
            return t
        return _Pvary.apply(t, self, axes)

    def pmin(self, t: Tensor, axes: Axes) -> Tensor:
        """The minimum over ``axes`` (no gradient)."""
        return self._ar(t.detach(), self._check(axes), "MIN")

    def pmax(self, t: Tensor, axes: Axes) -> Tensor:
        """The maximum over ``axes`` (no gradient)."""
        return self._ar(t.detach(), self._check(axes), "MAX")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim, invariant):
        ctx.mesh, ctx.axes, ctx.dim, ctx.inv = mesh, axes, dim, invariant
        ctx.size = t.shape[dim]
        return mesh._ag(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if ctx.inv:
            i = mesh.index(ctx.axes)
            return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, \
                None, None
        mesh._backward += 1
        try:
            out = mesh._rs(g, ctx.axes, ctx.dim)
        finally:
            mesh._backward -= 1
        return out, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh._rs(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        mesh._backward += 1
        try:
            out = mesh._ag(g, ctx.axes, ctx.dim)
        finally:
            mesh._backward -= 1
        return out, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh._ar(t, axes, "SUM")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        mesh._backward += 1
        try:
            out = mesh._ar(g, ctx.axes, "SUM")
        finally:
            mesh._backward -= 1
        return out, None, None


def make_production_mesh(multi_pod: bool = False, *, rank: int = 0,
                         device="meta") -> Mesh:
    """Rank ``rank``'s view of the production mesh, with no process
    group: 16 x 16 = 256 ranks over ("data", "model"), or with
    ``multi_pod`` 2 x 16 x 16 = 512 over ("pod", "data", "model").  Axis
    roles as the reference's: ("pod",) "data" = DP/FSDP, "model" =
    TP/EP (and query-parallel for the Quake engine)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device, rank=rank)


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
