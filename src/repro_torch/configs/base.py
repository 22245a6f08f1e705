"""The architecture registry.

Every registered architecture provides an ``ArchSpec``:

  * ``model_config()`` — the exact published configuration,
  * ``smoke_config()`` — a reduced same-family config for CPU tests,
  * ``shapes``          — its input-shape cells,
  * ``build(shape, mesh, smoke=False)`` — a ``Cell``: one rank's program
    on ``mesh`` with its arguments as ``meta`` tensors at the rank's local
    shapes, their specs, the donated arguments and a description.

The ``Cell`` is the counterpart of the reference's ``Lowering``: where
the reference lowers and compiles a jitted function for XLA to
partition, a cell holds the per-rank program written out
(``models/spmd.py``, the GAT's ``axis``, the recsys tables' row shards,
the engine's ``mapped_fn``).  ``Cell.count()`` runs it on ``meta``
(``roofline/count.py``); ``Cell.materialize`` draws its arguments on a
device, so the same program runs there.  Nothing here allocates device
memory for a full-size config.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch

from ..launch.mesh import P, shard_shape

Tree = Any


# ---------------------------------------------------------------------------
# Arguments: a local meta tensor with its spec and how to draw it
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Arg:
    """One argument leaf: its full ``shape``, ``dtype``, layout ``spec``
    and ``init``: ("normal", std), ("ones",), ("zeros",), ("randint",
    low, high), ("bernoulli", p) or ("call", fn) with ``fn(shape, dtype,
    device, generator)`` drawing the rank's local tensor."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: P = P()
    init: tuple = ("zeros",)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """``fn`` on every leaf of a nested structure of dicts, lists, tuples
    (named too) and dataclasses (not ``Arg``), rebuilt in kind."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, Arg):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return None if tree is None else fn(tree)


def _draw(a: Arg, shape, device, gen: torch.Generator) -> torch.Tensor:
    kind = a.init[0]
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device).mul_(
            a.init[1]).to(a.dtype)
    if kind == "ones":
        return torch.ones(shape, dtype=a.dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=a.dtype, device=device)
    if kind == "randint":
        return torch.randint(a.init[1], a.init[2], shape, generator=gen,
                             device=device).to(a.dtype)
    if kind == "bernoulli":
        return torch.rand(shape, generator=gen, device=device) < a.init[1]
    if kind == "call":
        return a.init[1](shape, a.dtype, device, gen)
    raise ValueError(f"unknown init {a.init!r}")


@dataclass
class Cell:
    """One (arch x shape x mesh) cell: rank ``mesh``'s program ``fn`` and
    its arguments."""
    fn: Callable
    args: Tuple[Tree, ...]             # Arg trees (full shapes, specs)
    mesh: Any
    donate: Tuple[int, ...] = ()
    description: str = ""
    reduced: Dict[str, Any] = field(default_factory=dict)
    # the outputs' layouts (a tree of ``P`` beside the outputs; None where
    # a leaf is laid out otherwise), and the config the program runs
    out_specs: Any = None
    config: Any = None

    def local_shape(self, a: Arg) -> Tuple[int, ...]:
        return shard_shape(a.shape, P(*(e if e is None or isinstance(e, str)
                                        else self.mesh.present(e)
                                        for e in a.spec)), self.mesh)

    def meta_args(self) -> Tuple[Tree, ...]:
        """The arguments as meta tensors at the rank's local shapes."""
        return tuple(tree_map(lambda a: torch.empty(
            self.local_shape(a), dtype=a.dtype, device="meta"), t)
            for t in self.args)

    def materialize(self, device, generator: torch.Generator
                    ) -> Tuple[Tree, ...]:
        """The arguments drawn on ``device`` at the rank's local shapes."""
        return tuple(tree_map(lambda a: _draw(
            a, self.local_shape(a), device, generator), t)
            for t in self.args)

    def shard(self, full: Tuple[Tree, ...]) -> Tuple[Tree, ...]:
        """The rank's pieces of whole arguments (trees of tensors beside
        ``args``), as the reference's ``device_put`` with a sharding
        hands a device its shard."""
        def one(a: Arg, t: torch.Tensor) -> torch.Tensor:
            return local_piece(t, a.spec, self.mesh)
        return tuple(_zip_map(one, a, t) for a, t in zip(self.args, full))

    def argument_bytes(self) -> int:
        total = 0
        for t in self.args:
            for a in _leaves(t):
                total += math.prod(self.local_shape(a)) \
                    * torch.empty((), dtype=a.dtype).element_size()
        return total

    def count(self) -> Dict[str, Any]:
        """The program counted on ``meta`` (``roofline.count.count_call``),
        with the cell's description and cuts."""
        from ..roofline.count import count_call
        res = count_call(self.fn, self.meta_args(), self.mesh)
        res.update(description=self.description, reduced=dict(self.reduced))
        return res


def local_piece(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The piece of the whole tensor ``t`` that ``spec`` gives this rank
    of ``mesh`` (a copy)."""
    for dim in range(len(spec)):
        axes = mesh.present(spec.axes(dim))
        if axes:
            n = t.shape[dim] // mesh.axis_size(axes)
            t = t.narrow(dim, mesh.index(axes) * n, n)
    return t.clone()


def _zip_map(fn, args: Tree, tensors: Tree) -> Tree:
    """``fn(arg, tensor)`` over an ``Arg`` tree and a tensor tree of the
    same structure."""
    if isinstance(args, Arg):
        return fn(args, tensors)
    if isinstance(args, dict):
        return {k: _zip_map(fn, v, tensors[k]) for k, v in args.items()}
    if isinstance(args, tuple) and hasattr(args, "_fields"):
        return type(args)(*(_zip_map(fn, a, t)
                            for a, t in zip(args, tensors)))
    if isinstance(args, (list, tuple)):
        return type(args)(_zip_map(fn, a, t) for a, t in zip(args, tensors))
    if dataclasses.is_dataclass(args):
        return type(args)(**{
            f.name: (None if getattr(args, f.name) is None else _zip_map(
                fn, getattr(args, f.name), getattr(tensors, f.name)))
            for f in dataclasses.fields(args)})
    return None


def _leaves(tree: Tree):
    out = []
    tree_map(out.append, tree)
    return out


@dataclass
class ArchSpec:
    name: str
    family: str                          # "lm" | "gnn" | "recsys" | "ann"
    source: str                          # citation tag
    shapes: Tuple[str, ...]
    model_config: Callable[[], Any]
    smoke_config: Callable[[], Any]
    build: Callable[..., Cell]           # (shape, mesh, smoke=False)
    notes: str = ""


REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_cells():
    for name, spec in REGISTRY.items():
        for shape in spec.shapes:
            yield name, shape


def dp_axes_for(mesh) -> Tuple[str, ...]:
    """Data-parallel axes present in this mesh (pod is dp when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
