"""Checkpoints with atomic commits and asynchronous writes: the JAX
package's ``train/checkpoint.py`` in PyTorch, in its format.

Format: one ``arrays.npz`` of flattened leaves (keys are the tree's
paths joined by "/"; a module contributes its ``named_parameters``, a
named tuple its field names) and a ``manifest.json`` (step, wall time,
leaf count and the caller's extras).  Commit protocol: write to
``<name>.tmp/``, then ``os.replace``, so a crash mid-write never
corrupts the latest checkpoint; the oldest beyond ``keep`` are removed.
bf16 and f16 leaves are stored as f32 (exactly) and cast back on
restore.

The reference's state is immutable; the port's is updated in place by
the next steps.  So ``save`` copies every leaf to the host before it
returns (a CPU tensor's ``.numpy()`` would share its memory), and only
the writing runs on the background thread.  ``restore`` returns new
tensors on ``device`` (in place of the reference's ``shardings``);
``restore_into`` loads into a live state.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device

Pytree = Any
_SEP = "/"


def _children(tree) -> Optional[Iterator[Tuple[str, Any]]]:
    """(key, child) of a tree node, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return iter(tree.named_parameters())
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return None


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        yield prefix[:-1], tree
        return
    for k, v in kids:
        yield from _leaves(v, f"{prefix}{k}{_SEP}")


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def snapshot(tree: Pytree) -> Dict[str, np.ndarray]:
    """Every leaf of ``tree`` copied to the host, by its path."""
    return {k: _host(v) for k, v in _leaves(tree)}


def _checked(flat: Dict[str, np.ndarray], key: str, like) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    arr = flat[key]
    shape = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                         f"model {shape}")
    return arr


def _rebuild(tree, flat, device, prefix=""):
    kids = _children(tree)
    if kids is None:
        arr = _checked(flat, prefix[:-1], tree)
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr).to(device=device, dtype=tree.dtype)
        return arr
    out = [(k, _rebuild(v, flat, device, f"{prefix}{k}{_SEP}"))
           for k, v in kids]
    if isinstance(tree, (nn.Module, dict)):
        return dict(out)
    if hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in out))
    return type(tree)(v for _, v in out)


@torch.no_grad()
def load_into(tree: Pytree, flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat``'s arrays into the leaves of a live ``tree`` (tensors
    and numpy arrays) in place.  Every leaf is checked (KeyError for a
    missing one, ValueError for another shape) before any is written."""
    pairs = [(leaf, _checked(flat, k, leaf)) for k, leaf in _leaves(tree)]
    for leaf, arr in pairs:
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.from_numpy(arr))
        else:
            leaf[...] = arr


def config_hash(obj: Any) -> str:
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:12]


@dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_write: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------------- save ----------------

    def save(self, step: int, state: Pytree,
             extra: Optional[Dict] = None, block: bool = False) -> str:
        """Snapshot then write: every leaf is copied to the host before
        this returns (the caller may update the state in place at once);
        the serialization runs on a background thread."""
        self.wait()
        flat = snapshot(state)
        manifest = {"step": int(step), "time": time.time(),
                    "leaves": len(flat), **(extra or {})}
        name = f"ckpt_{step:08d}"

        def write():
            tmp = os.path.join(self.directory, name + ".tmp")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = os.path.join(self.directory, name)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if self.async_write and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return os.path.join(self.directory, name)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for old in self.list()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, old),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def list(self):
        return sorted(d for d in os.listdir(self.directory)
                      if d.startswith("ckpt_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        """The step of the latest checkpoint, the one being written
        included (it waits for the writer; the reference's does not, so
        its supervisor can miss a checkpoint saved just before a
        failure)."""
        self.wait()
        ckpts = self.list()
        return int(ckpts[-1].split("_")[1]) if ckpts else None

    def read(self, step: Optional[int] = None
             ) -> Tuple[Dict[str, np.ndarray], Dict]:
        """(the arrays by path, the manifest) of checkpoint ``step``, the
        latest by default."""
        self.wait()
        ckpts = self.list()
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        name = f"ckpt_{step:08d}" if step is not None else ckpts[-1]
        path = os.path.join(self.directory, name)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return flat, manifest

    def restore(self, state_like: Pytree, step: Optional[int] = None,
                device="cuda") -> Tuple[Pytree, Dict]:
        """(a new state of ``state_like``'s structure, the manifest): its
        tensors on ``device`` in their dtypes, a module's parameters as a
        name -> tensor dict.  KeyError for a missing leaf, ValueError for
        a leaf of another shape."""
        dev = resolve_device(device)
        flat, manifest = self.read(step)
        return _rebuild(state_like, flat, dev), manifest

    def restore_into(self, state: Pytree, step: Optional[int] = None
                     ) -> Dict:
        """Load checkpoint ``step`` (the latest by default) into the live
        ``state`` in place; returns the manifest."""
        flat, manifest = self.read(step)
        load_into(state, flat)
        return manifest
