"""Device snapshot of the base level (paper §8.2), in pages.

``IndexSnapshot.from_index`` lays the ragged level-0 partitions out as
pages of ``S`` slots, a ``(pages, S, d)`` tensor on the index's device
that the batched executor's scans read; a page directory,
``page_start`` (P + 1,), says that partition j holds pages
``[page_start[j], page_start[j + 1])``, its rows packed from the first
slot of its first page on.  Given ``page_size``, each partition takes the
pages its rows fill (at least one) and ``headroom - 1`` times its rows
again in whole pages of slack, so the padding is bounded per partition;
without it the snapshot is dense, a page a partition of the largest
partition's size (times ``headroom``), which is the JAX package's layout
and its flat indices.  ``build_patch`` / ``apply_delta`` refresh only the
pages of the partitions a journal delta dirtied; an int8 snapshot
(``scales`` set) cannot be patched and is rebuilt instead.
``parts=(lo, hi)`` builds only the pages of the block of partitions one
shard of the sharded engine (``core/distributed.py``) holds, and
``synthetic`` makes a seeded random dense snapshot with no index behind
it.  ``to_storage`` puts f32 rows given block by block into a storage
type; every builder that converts rows goes through it.
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
BLOCK_BYTES = 256 << 20   # f32 bytes of pages from_index stages at once
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

Blocks = Iterator[Tuple[int, int, Tensor, Tensor]]


def to_storage(blocks: Blocks, shape: Tuple[int, int, int], dtype,
               device) -> Tuple[Tensor, Optional[Tensor]]:
    """Snapshot contents of ``shape`` (pages, S, d) in the storage type
    ``dtype`` from f32 rows given block by block, ``(lo, hi, centroids
    (hi-lo, d), rows (hi-lo, S, d))`` (each page's partition's centroid):
    f32, bf16, or int8 IVF-residual codes with per-slot scales
    (``scales`` is None for the float types).  Each block is converted as
    it comes, so no f32 copy of the whole is ever held."""
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
    """A whole dense snapshot's rows as ``to_storage``'s blocks of
    ``Q8_PARTS`` partitions."""
    for lo in range(0, data.shape[0], Q8_PARTS):
        hi = min(lo + Q8_PARTS, data.shape[0])
        yield lo, hi, centroids[lo:hi], data[lo:hi]


def page_counts(sizes: np.ndarray, page_size: int,
                headroom: float) -> np.ndarray:
    """Pages each partition of ``sizes`` takes: the pages its rows fill,
    at least one, and ``headroom - 1`` times its rows again in whole pages
    of slack (besides the free tail of its last page)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    slack = np.floor((max(headroom, 1.0) - 1.0) * sizes / page_size)
    return used_pages(sizes, page_size) + slack.astype(np.int64)


def used_pages(sizes, page_size: int):
    """Pages that hold rows: ceil(size / page_size), at least one (an
    empty partition keeps one inert page), on numpy or torch sizes."""
    if torch.is_tensor(sizes):
        return torch.clamp((sizes.long() + page_size - 1) // page_size,
                           min=1)
    return np.maximum(-(-np.asarray(sizes, dtype=np.int64) // page_size), 1)


@dataclass
class SnapshotPatch:
    """Host-side replacement pages for a subset of snapshot partitions —
    the unit of incremental refresh, built against a fixed page layout by
    ``IndexSnapshot.build_patch``."""
    rows: np.ndarray        # (R,) int32 partition ids, sorted, distinct
    pages: np.ndarray       # (G,) int64 their pages, in partition order
    data: np.ndarray        # (G, S, d) float32
    ids: np.ndarray         # (G, S) int32, -1 on padding
    centroids: np.ndarray   # (R, d) float32
    sizes: np.ndarray       # (R,) int32


@dataclass
class IndexSnapshot:
    """The base level in pages, on one device.

    data:       (G, S, d)  pages of partition rows (f32, bf16, or int8
                           residual codes), S slots a page
    ids:        (G, S)     external ids (int32), -1 on padding
    centroids:  (P, d)
    sizes:      (P,)       partition sizes
    beta_table: (1024,)    regularized-incomplete-beta grid
    scales:     (G, S)     per-slot dequantization scales (int8 only)
    page_start: (P + 1,)   int64: partition j's pages are
                           [page_start[j], page_start[j + 1]); None is the
                           dense layout, a page a partition (G = P)

    A flat index, the scans' result, is ``page * S + slot``.
    """
    data: Tensor
    ids: Tensor
    centroids: Tensor
    sizes: Tensor
    beta_table: Tensor
    scales: Optional[Tensor] = None
    page_start: Optional[Tensor] = None

    @property
    def num_partitions(self) -> int:
        return self.sizes.shape[0]

    @property
    def num_pages(self) -> int:
        return self.data.shape[0]

    @property
    def capacity(self) -> int:
        """Slots a page (a whole partition's in the dense layout)."""
        return self.data.shape[1]

    @property
    def dim(self) -> int:
        return self.data.shape[2]

    @property
    def dense(self) -> bool:
        """A page a partition."""
        return self.num_pages == self.num_partitions

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
                   device=None,
                   page_size: Optional[int] = None) -> "IndexSnapshot":
        """Snapshot of the base level on the index's device (or
        ``device``).  With ``page_size`` the pages hold ``page_size``
        slots and each partition takes ``page_counts`` of them (its rows'
        pages and ``headroom - 1`` times its rows of slack); without it
        the layout is dense: a page a partition of ``capacity`` slots, by
        default the largest partition times ``headroom``, aligned
        (``align_capacity``), and an explicit ``capacity`` below the
        largest partition raises.  The rows cross to the device a block
        of pages at a time (``BLOCK_BYTES`` of f32) and go into place
        there, so neither side holds another copy of them all.  ``dtype``
        is the storage type: f32 or bf16 rows, or IVF-residual int8 codes
        and per-slot scales, each page quantized against its partition's
        centroid (``to_storage``).  ``pad_partitions_to`` rounds the
        partition count up to a multiple with empty partitions (a page
        each) whose centroids sit far away (1e6), as in the JAX package,
        so the scan operands keep their shape across a few maintenance
        splits.  ``parts=(lo, hi)`` keeps the pages of partitions
        ``[lo, hi)`` of that padded directory only: one shard's block,
        whose flat indices and page directory are local to it; a dense
        block's page size is the whole directory's, so every shard has
        the same."""
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
        if dtype not in STORAGE.values():
            raise ValueError(f"dtype must be f32, bf16 or int8, got {dtype}")
        sizes_all = np.zeros(p_all, dtype=np.int64)
        sizes_all[:p_real] = lvl0.sizes()
        biggest = int(sizes_all.max(initial=0))
        if page_size is None:
            s_cap = capacity if capacity is not None else max(
                int(math.ceil(biggest * max(headroom, 1.0))), 1)
            s_cap = IndexSnapshot.align_capacity(s_cap)
            if biggest > s_cap:
                raise ValueError(
                    f"IndexSnapshot capacity {s_cap} would truncate a "
                    f"partition of size {biggest}")
            npages = np.ones(p_all, dtype=np.int64)
        else:
            if capacity is not None:
                raise ValueError("give a capacity (dense) or a page_size, "
                                 "not both")
            s_cap = int(page_size)
            if s_cap < 1:
                raise ValueError(f"page_size must be >= 1, got {s_cap}")
            npages = page_counts(sizes_all, s_cap, headroom)
        start_all = np.concatenate([[0], np.cumsum(npages)])
        start = start_all[lo:hi + 1] - start_all[lo]
        p, g, d = hi - lo, int(start[-1]), index.dim
        sizes = sizes_all[lo:hi]

        ids = np.full(g * s_cap, -1, dtype=np.int32)
        for j in range(lo, min(hi, p_real)):
            s = int(sizes_all[j])
            if s == 0:
                continue
            ext = lvl0.ids[j]
            if int(ext.max()) > np.iinfo(np.int32).max:
                raise ValueError(
                    "IndexSnapshot stores external ids as int32; id "
                    f"{int(ext.max())} does not fit (partition {j})")
            base = int(start[j - lo]) * s_cap
            ids[base:base + s] = ext
        cents = np.full((p, d), 1e6, dtype=np.float32)
        n_real = max(min(hi, p_real) - lo, 0)
        cents[:n_real] = lvl0.centroids[lo:lo + n_real]
        centroids = torch.as_tensor(cents, device=dev)
        page_part = np.repeat(np.arange(p), np.diff(start))
        step = max(1, BLOCK_BYTES // (s_cap * d * 4))
        if dtype == torch.int8:
            step = min(step, Q8_PARTS)
        page_cents = centroids.index_select(
            0, torch.as_tensor(page_part, device=dev))

        def blocks() -> Blocks:
            for g0 in range(0, g, step):
                g1 = min(g, g0 + step)
                block = torch.zeros(((g1 - g0) * s_cap, d),
                                    dtype=torch.float32, device=dev)
                flat, rows = _page_rows(lvl0, sizes, start, lo, p_real,
                                        s_cap, g0, g1)
                if rows is not None:
                    block.index_copy_(
                        0, torch.as_tensor(flat, device=dev),
                        torch.as_tensor(rows, device=dev))
                yield g0, g1, page_cents[g0:g1], block.reshape(
                    g1 - g0, s_cap, d)

        data, scales = to_storage(blocks(), (g, s_cap, d), dtype, dev)
        table = geometry.betainc_table(
            d if index.config.metric == "l2" else d + 1)
        return IndexSnapshot(
            data=data, ids=torch.as_tensor(ids, device=dev).reshape(g, s_cap),
            centroids=centroids,
            sizes=torch.as_tensor(sizes.astype(np.int32), device=dev),
            beta_table=torch.as_tensor(table, device=dev), scales=scales,
            page_start=torch.as_tensor(start, device=dev))

    @staticmethod
    def build_patch(index, rows, capacity: int,
                    page_start: Optional[np.ndarray] = None
                    ) -> SnapshotPatch:
        """Host-side patch for ``rows`` (level-0 partition ids) against a
        snapshot of ``capacity`` slots a page whose page directory is
        ``page_start`` (host, P + 1; None: dense, a page a partition).
        Raises ``ValueError`` if a partition no longer fits its pages —
        the caller falls back to a full rebuild."""
        lvl0 = index.levels[0]
        uniq = sorted({int(j) for j in rows})
        if uniq and (uniq[0] < 0 or uniq[-1] >= lvl0.num_partitions):
            raise ValueError(f"patch rows {uniq} outside partition "
                             f"directory [0, {lvl0.num_partitions})")
        rows = np.asarray(uniq, dtype=np.int32)
        if page_start is None:
            first, npages = rows.astype(np.int64), np.ones(len(rows),
                                                           np.int64)
        else:
            page_start = np.asarray(page_start, dtype=np.int64)
            if uniq and uniq[-1] >= len(page_start) - 1:
                raise ValueError("patch rows outside the page directory")
            first = page_start[rows]
            npages = page_start[rows + 1] - first
        pages = np.concatenate([np.arange(f, f + n) for f, n in
                                zip(first, npages)] + [np.zeros(0, np.int64)])
        r, d = len(rows), index.dim
        data = np.zeros((len(pages), capacity, d), dtype=np.float32)
        ids = np.full((len(pages), capacity), -1, dtype=np.int32)
        flat_d = data.reshape(-1, d)
        flat_i = ids.reshape(-1)
        sizes = np.zeros(r, dtype=np.int32)
        at = 0
        for i, j in enumerate(rows):
            s = len(lvl0.vectors[j])
            if s > npages[i] * capacity:
                raise ValueError(
                    f"partition {j} (size {s}) exceeds its "
                    f"{npages[i] * capacity} snapshot slots")
            ext = lvl0.ids[j]
            if s and int(ext.max()) > np.iinfo(np.int32).max:
                raise ValueError(
                    "IndexSnapshot stores external ids as int32; id "
                    f"{int(ext.max())} does not fit (partition {j})")
            flat_d[at:at + s] = lvl0.vectors[j]
            flat_i[at:at + s] = ext
            sizes[i] = s
            at += int(npages[i]) * capacity
        cents = np.ascontiguousarray(
            lvl0.centroids[rows], dtype=np.float32) if r else \
            np.zeros((0, d), dtype=np.float32)
        return SnapshotPatch(rows=rows, pages=pages.astype(np.int64),
                             data=data, ids=ids, centroids=cents,
                             sizes=sizes)

    def apply_delta(self, patch: SnapshotPatch,
                    donate: bool = False) -> "IndexSnapshot":
        """A snapshot with the patch's partitions replaced; only the patch
        moves to the device.  ``donate=False`` copies the tensors first,
        so this snapshot stays readable; ``donate=True`` writes into this
        snapshot's tensors in place (``index_copy_``), so the refresh
        costs O(dirty pages) and this snapshot is the result."""
        if self.scales is not None:
            raise ValueError("apply_delta does not support quantized "
                             "(int8) snapshots; rebuild instead")
        if len(patch.rows) == 0:
            return self
        if int(patch.rows.max()) >= self.num_partitions \
                or int(patch.pages.max(initial=0)) >= self.num_pages:
            raise ValueError("patch rows outside snapshot partition range")
        if patch.data.shape[1] != self.capacity:
            raise ValueError(
                f"patch capacity {patch.data.shape[1]} != snapshot "
                f"capacity {self.capacity}")
        dev = self.data.device

        def put(t: Tensor, at: np.ndarray, rows_np: np.ndarray) -> Tensor:
            t = t if donate else t.clone()
            sel = torch.as_tensor(at.astype(np.int64), device=dev)
            src = torch.as_tensor(rows_np, device=dev).to(t.dtype)
            return t.index_copy_(0, sel, src)

        return IndexSnapshot(
            data=put(self.data, patch.pages, patch.data),
            ids=put(self.ids, patch.pages, patch.ids),
            centroids=put(self.centroids, patch.rows, patch.centroids),
            sizes=put(self.sizes, patch.rows, patch.sizes),
            beta_table=self.beta_table, page_start=self.page_start)

    @staticmethod
    def synthetic(p: int, s_cap: int, d: int, seed: int = 0,
                  dtype=torch.float32, device="cuda") -> "IndexSnapshot":
        """Random dense snapshot with no index behind it, for capacity
        runs and benchmarks: ``p`` full partitions of ``s_cap`` rows of
        width ``d`` (``synthetic_blocks`` draws them), ids ``arange(p *
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


def _page_rows(lvl0, sizes: np.ndarray, start: np.ndarray, lo: int,
               p_real: int, s_cap: int, g0: int, g1: int):
    """The rows that pages ``[g0, g1)`` of a block of partitions from
    ``lo`` hold: (flat slot of each within those pages, rows (n, d) f32),
    host arrays, or (None, None) when they hold none."""
    j0 = int(np.searchsorted(start, g0, side="right")) - 1
    j1 = int(np.searchsorted(start, g1, side="left"))
    flats, rows = [], []
    for j in range(max(j0, 0), min(j1, len(sizes))):
        if j + lo >= p_real or sizes[j] == 0:
            continue
        base = int(start[j]) * s_cap
        a = max(g0 * s_cap - base, 0)
        b = min(int(sizes[j]), g1 * s_cap - base)
        if b > a:
            flats.append(base - g0 * s_cap + np.arange(a, b, dtype=np.int64))
            rows.append(lvl0.vectors[j + lo][a:b])
    if not rows:
        return None, None
    return (np.concatenate(flats),
            np.concatenate(rows).astype(np.float32, copy=False))


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
