"""Dense device snapshot of the base level (paper §8.2).

``IndexSnapshot.from_index`` pads the ragged level-0 partitions into a
dense ``(P, S_cap, d)`` tensor on the index's device, the operand of the
batched executor's scans.  ``build_patch`` / ``apply_delta`` refresh only
the partitions a journal delta dirtied; an int8 snapshot (``scales`` set)
cannot be patched and is rebuilt instead.  ``parts=(lo, hi)`` builds only
the block of partitions one shard of the sharded engine
(``core/distributed.py``) holds, and ``synthetic`` makes a seeded random
snapshot with no index behind it.  ``to_storage`` puts f32 rows given
block by block into a storage type; every builder that converts rows
(int8 from an index, any type from ``synthetic`` or a whole snapshot)
goes through it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..kernels.ref import quantize_int8_residual
from . import geometry
from .device import resolve_device

Tensor = torch.Tensor

Q8_PARTS = 64    # partitions a snapshot pads and converts at once
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

Blocks = Iterator[Tuple[int, int, Tensor, Tensor]]


def to_storage(blocks: Blocks, shape: Tuple[int, int, int], dtype,
               device) -> Tuple[Tensor, Optional[Tensor]]:
    """Snapshot contents of ``shape`` (P, S_cap, d) in the storage type
    ``dtype`` from f32 rows given block by block, ``(lo, hi, centroids
    (hi-lo, d), rows (hi-lo, S_cap, d))``: f32, bf16, or int8
    IVF-residual codes with per-slot scales (``scales`` is None for the
    float types).  Each block is converted as it comes, so no f32 copy
    of the whole is ever held."""
    if dtype not in STORAGE.values():
        raise ValueError(f"dtype must be f32, bf16 or int8, got {dtype}")
    data = torch.empty(shape, dtype=dtype, device=device)
    scales = torch.empty(shape[:2], dtype=torch.float32, device=device) \
        if dtype == torch.int8 else None
    for lo, hi, cents, x in blocks:
        if scales is not None:
            data[lo:hi], scales[lo:hi] = quantize_int8_residual(
                x.float(), cents)
        else:
            data[lo:hi] = x
    return data, scales


def split_blocks(data: Tensor, centroids: Tensor) -> Blocks:
    """A whole snapshot's rows as ``to_storage``'s blocks of ``Q8_PARTS``
    partitions."""
    for lo in range(0, data.shape[0], Q8_PARTS):
        hi = min(lo + Q8_PARTS, data.shape[0])
        yield lo, hi, centroids[lo:hi], data[lo:hi]


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
                   dtype=torch.float32,
                   pad_partitions_to: int = 1,
                   parts: Optional[Tuple[int, int]] = None,
                   device=None) -> "IndexSnapshot":
        """Dense snapshot of the base level on the index's device (or
        ``device``).  Only the real rows cross to the device, in one copy,
        and are scattered into the zero-padded tensor there.  ``headroom``
        pads the slot capacity beyond the largest partition; an explicit
        ``capacity`` below the largest partition raises.  ``dtype`` is
        the storage type: f32 or bf16 rows, scattered into place, or
        IVF-residual int8 codes and per-slot scales, padded and quantized
        ``Q8_PARTS`` partitions at a time (``to_storage``), so no f32
        copy of the whole padded snapshot is ever on the device.
        ``pad_partitions_to`` rounds the partition count up to a multiple
        with empty partitions whose centroids sit far away (1e6), as in
        the JAX package, so the scan operands keep their shape across a
        few maintenance splits.  ``parts=(lo, hi)`` keeps partitions
        ``[lo, hi)`` of that padded directory only: one shard's block,
        whose flat indices are local to it; the slot capacity is the
        whole directory's, so every shard has the same."""
        dev = index.device if device is None else resolve_device(device)
        lvl0 = index.levels[0]
        p_real = lvl0.num_partitions
        pad = max(int(pad_partitions_to), 1)
        p_all = -(-p_real // pad) * pad
        lo, hi = (0, p_all) if parts is None else (int(parts[0]),
                                                  int(parts[1]))
        if not 0 <= lo <= hi <= p_all:
            raise ValueError(f"parts [{lo}, {hi}) outside the padded "
                             f"partition directory [0, {p_all})")
        p = hi - lo
        sizes_all = np.zeros(p_all, dtype=np.int32)
        sizes_all[:p_real] = lvl0.sizes()
        if capacity is None:
            s_cap = max(int(math.ceil(int(sizes_all.max(initial=0))
                                      * max(headroom, 1.0))), 1)
        else:
            s_cap = capacity
        s_cap = IndexSnapshot.align_capacity(s_cap)
        if int(sizes_all.max(initial=0)) > s_cap:
            raise ValueError(
                f"IndexSnapshot capacity {s_cap} would truncate a "
                f"partition of size {int(sizes_all.max())}")
        sizes = sizes_all[lo:hi].copy()
        d = index.dim
        rows, vecs, exts = [], [], []
        for j in range(lo, min(hi, p_real)):
            s = int(sizes_all[j])
            if s == 0:
                continue
            ext = lvl0.ids[j]
            if int(ext.max()) > np.iinfo(np.int32).max:
                raise ValueError(
                    "IndexSnapshot stores external ids as int32; id "
                    f"{int(ext.max())} does not fit (partition {j})")
            rows.append((j - lo) * s_cap + np.arange(s, dtype=np.int64))
            vecs.append(lvl0.vectors[j])
            exts.append(ext.astype(np.int32))
        ids = torch.full((p * s_cap,), -1, dtype=torch.int32, device=dev)
        cents = np.full((p, d), 1e6, dtype=np.float32)
        n_real = max(min(hi, p_real) - lo, 0)
        cents[:n_real] = lvl0.centroids[lo:lo + n_real]
        centroids = torch.as_tensor(cents, device=dev)
        flat = x = None
        if rows:
            flat = torch.as_tensor(np.concatenate(rows), device=dev)
            x = torch.as_tensor(np.concatenate(vecs).astype(np.float32),
                                device=dev)
            ids.index_copy_(0, flat, torch.as_tensor(
                np.concatenate(exts), device=dev))
        if dtype != torch.int8:
            # float storage: the rows go straight into place
            if dtype not in STORAGE.values():
                raise ValueError(f"dtype must be f32, bf16 or int8, got "
                                 f"{dtype}")
            data = torch.zeros((p * s_cap, d), dtype=dtype, device=dev)
            if rows:
                data.index_copy_(0, flat, x.to(dtype))
            data, scales = data.reshape(p, s_cap, d), None
        else:
            # rows are in partition order: partition j's are
            # [start[j], start[j + 1]) of flat and x
            start = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])

            def blocks() -> Blocks:
                for p0 in range(0, p, Q8_PARTS):
                    p1 = min(p, p0 + Q8_PARTS)
                    block = torch.zeros(((p1 - p0) * s_cap, d),
                                        dtype=torch.float32, device=dev)
                    lo_r, hi_r = int(start[p0]), int(start[p1])
                    if hi_r > lo_r:
                        block.index_copy_(0, flat[lo_r:hi_r] - p0 * s_cap,
                                          x[lo_r:hi_r])
                    yield p0, p1, centroids[p0:p1], block.reshape(
                        p1 - p0, s_cap, d)
            data, scales = to_storage(blocks(), (p, s_cap, d), dtype, dev)
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

    @staticmethod
    def synthetic(p: int, s_cap: int, d: int, seed: int = 0,
                  dtype=torch.float32, device="cuda") -> "IndexSnapshot":
        """Random snapshot with no index behind it, for capacity runs and
        benchmarks: ``p`` full partitions of ``s_cap`` rows of width
        ``d`` (``synthetic_blocks`` draws them), ids ``arange(p *
        s_cap)``, sizes ``s_cap``, the beta table of ``d``.  ``dtype`` is
        the storage type (``to_storage``): each block is converted as it
        is drawn, so the int8 form equals quantizing the f32 snapshot and
        no f32 copy of the whole is ever on the device."""
        dev = resolve_device(device)
        data, scales = to_storage(synthetic_blocks(p, s_cap, d, seed, dev),
                                  (p, s_cap, d), dtype, dev)
        cents = synthetic_centroids(p, d, seed, dev)
        return IndexSnapshot(
            data=data,
            ids=torch.arange(p * s_cap, dtype=torch.int32,
                             device=dev).reshape(p, s_cap),
            centroids=cents,
            sizes=torch.full((p,), s_cap, dtype=torch.int32, device=dev),
            beta_table=torch.as_tensor(geometry.betainc_table(d),
                                       device=dev),
            scales=scales)


def _generator(dev: torch.device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.SeedSequence([seed, stream]).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1)))
    return g


def synthetic_centroids(p: int, d: int, seed: int, device) -> Tensor:
    """The (p, d) centroids of ``IndexSnapshot.synthetic``: 3·N(0, 1)
    from one ``torch.Generator`` seeded from ``(seed, 0)``."""
    dev = resolve_device(device)
    return torch.randn((p, d), generator=_generator(dev, seed, 0),
                       device=dev) * 3.0


def synthetic_blocks(p: int, s_cap: int, d: int, seed: int = 0,
                     device="cuda") -> Blocks:
    """The f32 contents of ``IndexSnapshot.synthetic``, ``Q8_PARTS``
    partitions at a time: ``(lo, hi, centroids (hi-lo, d), rows (hi-lo,
    s_cap, d))``.  Centroids are 3·N(0, 1) and rows centroid + N(0, 1),
    the JAX package's distribution; its PRNG stream is not reproduced.
    The centroids come from one ``torch.Generator`` seeded from ``(seed,
    0)`` and each block's noise from its own, seeded from ``(seed, 1 +
    block)``, so the blocks are the same however many are drawn (on one
    device type: the CPU and CUDA generators draw different numbers)."""
    dev = resolve_device(device)
    cents = synthetic_centroids(p, d, seed, dev)
    for lo in range(0, p, Q8_PARTS):
        hi = min(lo + Q8_PARTS, p)
        noise = torch.randn((hi - lo, s_cap, d), device=dev,
                            generator=_generator(dev, seed,
                                                 1 + lo // Q8_PARTS))
        yield lo, hi, cents[lo:hi], cents[lo:hi, None, :] + noise
