"""Counting one rank's program as the card would run it, on ``meta``.

``count_call(fn, args, mesh)`` runs ``fn(*args)`` (meta tensors at the
rank's local shapes, the kernels' wrappers on the card's route through
``build.card_route_on_meta``) and reads:

- ``arguments``: the bytes of the arguments' storages, and
  ``arguments_used`` those of the storages some op reads (XLA drops an
  argument that the program never reads from its compiled module's
  argument size);
- ``peak``: the largest sum of the bytes of the storages the program
  made and that were alive at once (``LiveBytes``: a dispatch mode that
  sees every new storage an op returns and a weakref finalizer on each);
  the outputs still alive at the end are part of it, as they are of the
  card's ``max_memory_allocated``;
- ``outputs``: the outputs' bytes that do not alias an argument's storage
  (a donated argument updated in place costs nothing more);
- ``flops``: each op's count by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s), plus each kernel wrapper's own count
  (``build.META_WORK``); ``flops_by_dtype`` splits the ops' part by the
  dtype of their first tensor input, so that each part can be rated at
  the card's peak for its type;
- ``bytes_accessed``: the sum over ops of their tensor inputs' and
  outputs' bytes, unfused (each op as if it read and wrote device memory),
  plus the kernels' own bytes;
- the collectives that ``mesh`` recorded.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import build

Tensor = torch.Tensor


def tensors_of(tree, out: List[Tensor] = None) -> List[Tensor]:
    """The tensors of a nested structure of dicts, lists, tuples (named
    too) and dataclasses, in order.  (No recursive closure: one would
    hold ``out`` in a reference cycle, keeping every op's tensors alive
    until the garbage collector runs.)"""
    out = [] if out is None else out
    if isinstance(tree, Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            tensors_of(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tensors_of(v, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            tensors_of(getattr(tree, name), out)
    return out


def storage_bytes(tensors: Iterable[Tensor]) -> int:
    """The bytes of the distinct storages under ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, Tensor) else 0


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of the storages that ops make while it is on:
    ``live`` now, ``peak`` the most at once; ``accessed``, each op's
    tensor inputs and outputs summed; and ``flops``, each op's count by
    the dtype of its first tensor input.  Storages that existed before (the
    arguments') are not counted.  ``granule`` rounds each storage up to a
    multiple of it (512: the CUDA caching allocator's)."""

    def __init__(self, known: Iterable[Tensor] = (), granule: int = 1):
        super().__init__()
        self.granule = granule
        known = list(known)
        self._seen = weakref.WeakSet(t.untyped_storage() for t in known)
        self._known = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                       for t in known}
        self.read: Dict[int, int] = {}     # known storages an op read
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self.flops: Dict[str, float] = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = tensors_of((args, kwargs or {}))
        outs = tensors_of(out)
        self.accessed += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None and ins:
            dt = str(ins[0].dtype).replace("torch.", "")
            self.flops[dt] = self.flops.get(dt, 0.0) + float(
                formula(*args, **(kwargs or {}), out_val=out))
        if not getattr(func, "is_view", False):    # a view reads nothing
            for t in ins:
                k = id(t.untyped_storage())
                if k in self._known:
                    self.read[k] = self._known[k]
        for t in outs:
            s = t.untyped_storage()
            if s in self._seen:
                continue
            self._seen.add(s)
            n = -(-s.nbytes() // self.granule) * self.granule
            self.live += n
            weakref.finalize(s, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def count_call(fn, args: tuple, mesh=None) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the counters; see the module's
    docstring.  Returns the counts and the outputs' count of tensors."""
    arg_tensors = tensors_of(args)
    if mesh is not None:
        mesh.notes = []
    build.META_WORK.reset()
    live = LiveBytes(arg_tensors)
    record = (mesh.recording() if mesh is not None
              else contextlib.nullcontext())
    with build.card_route_on_meta(), record, live:
        out = fn(*args)
    arg_ids = {id(t.untyped_storage()) for t in arg_tensors}
    outs = [t for t in tensors_of(out)
            if id(t.untyped_storage()) not in arg_ids]
    res = {
        "arguments": storage_bytes(arg_tensors),
        "arguments_used": sum(live.read.values()),
        "peak": live.peak,
        "outputs": storage_bytes(outs),
        "flops": float(sum(live.flops.values())),
        "flops_by_dtype": dict(live.flops),
        "bytes_accessed": float(live.accessed),
        "kernels": {k: dict(v) for k, v in
                    build.META_WORK.by_kernel.items()},
    }
    for w in build.META_WORK.by_kernel.values():
        res["flops"] += w["ops"]
        res["bytes_accessed"] += w["bytes"]
    if mesh is not None:
        res["collectives"] = mesh.collective_totals()
        res["notes"] = list(getattr(mesh, "notes", []))
    del out, outs
    return res
