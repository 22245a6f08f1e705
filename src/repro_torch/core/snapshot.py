"""Dense device snapshot of the base level (paper §8.2).

``IndexSnapshot.from_index`` pads the ragged level-0 partitions into a
dense ``(P, S_cap, d)`` tensor on the index's device, the operand of the
batched executor's scans.  ``build_patch`` / ``apply_delta`` refresh only
the partitions a journal delta dirtied; an int8 snapshot (``scales`` set)
cannot be patched and is rebuilt instead.  The sharded engine that serves
these snapshots across devices in the JAX package comes with a later
slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.ref import quantize_int8_residual
from . import geometry

Tensor = torch.Tensor

Q8_PARTS = 64    # partitions an int8 snapshot pads and quantizes at once


@dataclass
class SnapshotPatch:
    """Host-side replacement rows for a subset of snapshot partitions —
    the unit of incremental refresh, built against a fixed slot capacity
    by ``IndexSnapshot.build_patch``."""
    rows: np.ndarray        # (R,) int32 partition ids, sorted, distinct
    data: np.ndarray        # (R, S_cap, d) float32
    ids: np.ndarray         # (R, S_cap) int32, -1 on padding
    centroids: np.ndarray   # (R, d) float32
    sizes: np.ndarray       # (R,) int32


@dataclass
class IndexSnapshot:
    """Dense view of the base level, on one device.

    data:      (P, S_cap, d)  padded partition contents (f32, bf16, or
                              int8 residual codes)
    ids:       (P, S_cap)     external ids (int32), -1 on padding
    centroids: (P, d)
    sizes:     (P,)           partition sizes
    beta_table:(1024,)        regularized-incomplete-beta grid
    scales:    (P, S_cap)     per-slot dequantization scales (int8 only)
    """
    data: Tensor
    ids: Tensor
    centroids: Tensor
    sizes: Tensor
    beta_table: Tensor
    scales: Optional[Tensor] = None

    @property
    def num_partitions(self) -> int:
        return self.data.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.shape[1]

    @property
    def dim(self) -> int:
        return self.data.shape[2]

    @staticmethod
    def align_capacity(s_cap: int) -> int:
        """Round a slot capacity up: next power of two up to 512, next
        multiple of 512 above (the JAX package's tile rule, kept so both
        packages give the same flat indices)."""
        s_cap = max(s_cap, 8)
        if s_cap <= 512:
            p2 = 8
            while p2 < s_cap:
                p2 *= 2
            return p2
        return -(-s_cap // 512) * 512

    @staticmethod
    def from_index(index, capacity: Optional[int] = None,
                   headroom: float = 1.0,
                   int8: bool = False) -> "IndexSnapshot":
        """Dense snapshot of the base level on the index's device.  Only
        the real rows cross to the device, in one copy, and are scattered
        into the zero-padded tensor there.  ``headroom`` pads the slot
        capacity beyond the largest partition; an explicit ``capacity``
        below the largest partition raises.  With ``int8`` the snapshot
        holds IVF-residual int8 codes and per-slot scales, padded and
        quantized ``Q8_PARTS`` partitions at a time, so no f32 copy of
        the whole padded snapshot is ever on the device."""
        dev = index.device
        lvl0 = index.levels[0]
        p = lvl0.num_partitions
        sizes = lvl0.sizes().astype(np.int32)
        if capacity is None:
            s_cap = max(int(math.ceil(int(sizes.max(initial=0))
                                      * max(headroom, 1.0))), 1)
        else:
            s_cap = capacity
        s_cap = IndexSnapshot.align_capacity(s_cap)
        if int(sizes.max(initial=0)) > s_cap:
            raise ValueError(
                f"IndexSnapshot capacity {s_cap} would truncate a "
                f"partition of size {int(sizes.max())}")
        d = index.dim
        rows, vecs, exts = [], [], []
        for j in range(p):
            s = int(sizes[j])
            if s == 0:
                continue
            ext = lvl0.ids[j]
            if int(ext.max()) > np.iinfo(np.int32).max:
                raise ValueError(
                    "IndexSnapshot stores external ids as int32; id "
                    f"{int(ext.max())} does not fit (partition {j})")
            rows.append(j * s_cap + np.arange(s, dtype=np.int64))
            vecs.append(lvl0.vectors[j])
            exts.append(ext.astype(np.int32))
        ids = torch.full((p * s_cap,), -1, dtype=torch.int32, device=dev)
        centroids = torch.as_tensor(
            np.ascontiguousarray(lvl0.centroids, dtype=np.float32),
            device=dev)
        flat = x = None
        if rows:
            flat = torch.as_tensor(np.concatenate(rows), device=dev)
            x = torch.as_tensor(np.concatenate(vecs).astype(np.float32),
                                device=dev)
            ids.index_copy_(0, flat, torch.as_tensor(
                np.concatenate(exts), device=dev))
        scales = None
        if not int8:
            data = torch.zeros((p * s_cap, d), dtype=torch.float32,
                               device=dev)
            if rows:
                data.index_copy_(0, flat, x)
            data = data.reshape(p, s_cap, d)
        else:
            data = torch.empty((p, s_cap, d), dtype=torch.int8, device=dev)
            scales = torch.empty((p, s_cap), dtype=torch.float32,
                                 device=dev)
            # rows are in partition order: partition j's are
            # [start[j], start[j + 1]) of flat and x
            start = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
            for p0 in range(0, p, Q8_PARTS):
                p1 = min(p, p0 + Q8_PARTS)
                block = torch.zeros(((p1 - p0) * s_cap, d),
                                    dtype=torch.float32, device=dev)
                lo, hi = int(start[p0]), int(start[p1])
                if hi > lo:
                    block.index_copy_(0, flat[lo:hi] - p0 * s_cap,
                                      x[lo:hi])
                data[p0:p1], scales[p0:p1] = quantize_int8_residual(
                    block.reshape(p1 - p0, s_cap, d), centroids[p0:p1])
        table = geometry.betainc_table(
            d if index.config.metric == "l2" else d + 1)
        return IndexSnapshot(
            data=data, ids=ids.reshape(p, s_cap), centroids=centroids,
            sizes=torch.as_tensor(sizes, device=dev),
            beta_table=torch.as_tensor(table, device=dev), scales=scales)

    @staticmethod
    def build_patch(index, rows, capacity: int) -> SnapshotPatch:
        """Host-side patch for ``rows`` (level-0 partition ids) against a
        snapshot of slot capacity ``capacity``.  Raises ``ValueError`` if a
        row no longer fits — the caller falls back to a full rebuild."""
        lvl0 = index.levels[0]
        uniq = sorted({int(j) for j in rows})
        if uniq and (uniq[0] < 0 or uniq[-1] >= lvl0.num_partitions):
            raise ValueError(f"patch rows {uniq} outside partition "
                             f"directory [0, {lvl0.num_partitions})")
        rows = np.asarray(uniq, dtype=np.int32)
        r, d = len(rows), index.dim
        data = np.zeros((r, capacity, d), dtype=np.float32)
        ids = np.full((r, capacity), -1, dtype=np.int32)
        sizes = np.zeros(r, dtype=np.int32)
        for i, j in enumerate(rows):
            s = len(lvl0.vectors[j])
            if s > capacity:
                raise ValueError(
                    f"partition {j} (size {s}) exceeds snapshot "
                    f"capacity {capacity}")
            ext = lvl0.ids[j]
            if s and int(ext.max()) > np.iinfo(np.int32).max:
                raise ValueError(
                    "IndexSnapshot stores external ids as int32; id "
                    f"{int(ext.max())} does not fit (partition {j})")
            data[i, :s] = lvl0.vectors[j]
            ids[i, :s] = ext
            sizes[i] = s
        cents = np.ascontiguousarray(
            lvl0.centroids[rows], dtype=np.float32) if r else \
            np.zeros((0, d), dtype=np.float32)
        return SnapshotPatch(rows=rows, data=data, ids=ids,
                             centroids=cents, sizes=sizes)

    def apply_delta(self, patch: SnapshotPatch,
                    donate: bool = False) -> "IndexSnapshot":
        """A snapshot with the patch rows replaced; only the patch moves to
        the device.  ``donate=False`` copies the tensors first, so this
        snapshot stays readable; ``donate=True`` writes into this
        snapshot's tensors in place (``index_copy_``), so the refresh
        costs O(dirty rows) and this snapshot is the result."""
        if self.scales is not None:
            raise ValueError("apply_delta does not support quantized "
                             "(int8) snapshots; rebuild instead")
        if len(patch.rows) == 0:
            return self
        if int(patch.rows.max()) >= self.num_partitions:
            raise ValueError("patch rows outside snapshot partition range")
        if patch.data.shape[1] != self.capacity:
            raise ValueError(
                f"patch capacity {patch.data.shape[1]} != snapshot "
                f"capacity {self.capacity}")
        dev = self.data.device
        sel = torch.as_tensor(patch.rows.astype(np.int64), device=dev)

        def put(t: Tensor, rows_np: np.ndarray) -> Tensor:
            t = t if donate else t.clone()
            src = torch.as_tensor(rows_np, device=dev).to(t.dtype)
            return t.index_copy_(0, sel, src)

        return IndexSnapshot(
            data=put(self.data, patch.data), ids=put(self.ids, patch.ids),
            centroids=put(self.centroids, patch.centroids),
            sizes=put(self.sizes, patch.sizes), beta_table=self.beta_table)
