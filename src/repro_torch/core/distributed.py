"""Mesh-sharded Quake serving engine over torch.distributed: NUMA-aware
query processing (paper §6, Algorithm 2) across devices.

The port of the JAX package's ``core/distributed.py``.  Mapping:

  NUMA node                  ->  one rank and its device
  round-robin partition      ->  the partition axis split over the mesh's
  placement                      ``part_axes``: each rank holds one block
  worker threads scan local  ->  SPMD: every rank runs the same code on its
  partitions                     own block of partitions and its own block
                                 of queries
  coordinator merges every   ->  per-round hierarchical top-k merge
  T_wait + recall check          (``all_gather`` over the partition axes)
                                 and an all-reduced APS recall estimate; a
                                 Python loop whose all-reduced condition is
                                 read once a round ends the batch when
                                 every query met its target

The batch is split over ``batch_axis`` when the mesh has it, so a
("pod", "data", "model") mesh gives partition x query parallelism.  The
public entry points return the whole batch on every rank (an
``all_gather`` over the batch axis at the end), which is what a caller of
the JAX package's jitted ``shard_map`` sees.  Partition indices never
cross shards (flat indices are local to a block); external ids do.

Entry points: ``search_fixed`` (static nprobe), ``search_adaptive`` (APS
rounds), ``search_bruteforce`` (exact, through the dense ``scan_topk``
kernel over the block's rows, never a (B, P*S_cap) distance matrix) and
``search_batch`` (the batched executor's planner and round loop over the
sharded snapshot).  Partition scans go through ``ops.scan_selected_topk``
/ ``ops.scan_selected_topk_q8``: the indexed kernels at ``scan_impl=
"union_cuda"``, their plain PyTorch oracles at ``"union_torch"``, or the
per-query gather of the JAX package's ``"gather"`` baseline.

Two faults of the JAX engine are not copied.  Its brute force and its
gather scan read int8 residual codes as if they were vectors, ignoring
``scales`` and ``centroids``; here both raise ``ValueError`` on int8
storage.  Its bf16 brute force sums ||x||^2 in bf16; here the dense
kernel sums it in f32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops, ref
from ..kernels.ref import MASK_DIST
from . import geometry
from .multiquery import (STORAGE_DTYPES, BatchResult, PlannerCache,
                         _batch_rho_fn, plan_batch, plan_rounds,
                         run_round_loop, to_host)
from .snapshot import STORAGE, IndexSnapshot, split_blocks, to_storage

if TYPE_CHECKING:
    from ..launch.mesh import Mesh

Tensor = torch.Tensor

SCAN_IMPLS = ("gather", "union_torch", "union_cuda")
INT8_FAULT = ("reads int8 residual codes as if they were vectors, "
              "ignoring scales and centroids (a fault of the JAX engine, "
              "ROADMAP Queue 3); use scan_impl='union_torch' or "
              "'union_cuda' with int8 storage")


def _smallest(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Ascending top-k of the last axis, ties to the earlier position
    (``jax.lax.top_k`` of ``-d``)."""
    vals, pos = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]


@dataclass(frozen=True)
class EngineConfig:
    metric: str = "l2"
    k: int = 100
    nprobe: int = 16             # search_fixed probes (per whole index)
    chunk: int = 2               # adaptive: local partitions per round
    max_rounds: int = 16
    recall_target: float = 0.9
    batch_axis: Optional[str] = "model"   # query-parallel axis (None = off)
    part_axes: Tuple[str, ...] = ("data",)  # partition-parallel axes
    # scan implementation:
    #  "gather":      per-query gather + einsum (the JAX package's
    #                 paper-faithful baseline)
    #  "union_torch": batch-deduped union scan through the plain PyTorch
    #                 oracles (the JAX package's "union_jnp")
    #  "union_cuda":  union scan through the hand-written indexed kernels
    #                 (the JAX package's "union_pallas"); their plain
    #                 versions on CPU tensors
    scan_impl: str = "gather"
    union_cap: Optional[int] = None  # union size; None = B_loc * n_sel
    storage_dtype: str = "f32"       # "bf16" halves scan traffic; "int8"
                                     # IVF-residual codes (union scans only)
    rounds: Optional[int] = None     # search_batch round budget (APS mode):
                                     # None = as many as the plan needs,
                                     # 1 = one fixed-plan scan


class ShardedQuakeEngine:
    """Search over a snapshot whose partitions are split over a mesh."""

    def __init__(self, mesh: Mesh, config: EngineConfig):
        if config.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"scan_impl must be one of {SCAN_IMPLS}, got "
                             f"{config.scan_impl!r}")
        if config.storage_dtype not in STORAGE_DTYPES:
            raise ValueError(f"storage_dtype must be one of "
                             f"{STORAGE_DTYPES}, got "
                             f"{config.storage_dtype!r}")
        if config.metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric: {config.metric}")
        self.mesh = mesh
        self.cfg = config
        self.device = mesh.device
        self.n_part_shards = mesh.axis_size(config.part_axes)
        self.part_index = mesh.index(config.part_axes)
        self.batch_axis = config.batch_axis if (
            config.batch_axis in mesh.axis_names) else None
        if self.batch_axis in config.part_axes:
            raise ValueError(f"batch axis {self.batch_axis!r} is also a "
                             f"partition axis")
        self._batch_axes = (self.batch_axis,) if self.batch_axis else ()
        self.n_batch_shards = mesh.axis_size(self._batch_axes)
        self.batch_index = mesh.index(self._batch_axes)
        # the groups are created collectively, in this order on every rank
        mesh.group(config.part_axes)
        mesh.group(self._batch_axes)
        # the ops' impl: the plain oracles at "union_torch", else the
        # kernel path (brute force runs on the dense kernel at "gather")
        self._impl = "torch" if config.scan_impl == "union_torch" else "cuda"
        # journal-aware sharded snapshot cache (refresh_snapshot)
        self._snap: Optional[IndexSnapshot] = None
        self._snap_version = -1
        self._p_pad = 0              # partitions of the whole directory
        self._host_sizes: Optional[np.ndarray] = None  # (P,) all shards'
        self._planner_cache: Optional[PlannerCache] = None
        self.full_rebuilds = 0
        self.delta_refreshes = 0

    # ---- sharding specs ----
    def snapshot_spec(self) -> IndexSnapshot:
        """The snapshot's layout: partitions split over the partition
        axes, the beta table replicated."""
        from ..launch.mesh import P
        pa = P(self.cfg.part_axes)
        return IndexSnapshot(
            data=pa, ids=pa, centroids=pa, sizes=pa, beta_table=P(),
            scales=pa if self.cfg.storage_dtype == "int8" else None)

    def query_spec(self):
        """The queries' layout: rows over the batch axis, if any."""
        from ..launch.mesh import P
        return P(self.batch_axis) if self.batch_axis else P()

    def mapped_fn(self, kind: str):
        """The per-rank search of ``kind`` ("fixed", "adaptive" or
        "brute"): ``fn(q, snap)`` of this rank's queries (its rows of the
        batch axis) and its block of the snapshot, returning the rank's
        rows of the results (the JAX engine's ``shard_map``'d callable,
        before the public entry points gather the batch)."""
        return {"fixed": self._search_fixed_local,
                "adaptive": self._search_adaptive_local,
                "brute": self._search_brute_local}[kind]

    # ---- snapshots ----
    def _block(self, p_pad: int) -> Tuple[int, int]:
        if p_pad % self.n_part_shards:
            raise ValueError(
                f"{p_pad} partitions do not split over "
                f"{self.n_part_shards} partition shards; pad them "
                f"(pad_partitions_to={self.n_part_shards})")
        p_loc = p_pad // self.n_part_shards
        return self.part_index * p_loc, (self.part_index + 1) * p_loc

    def shard_snapshot(self, snap: IndexSnapshot) -> IndexSnapshot:
        """This rank's block of a whole snapshot on the mesh's device, in
        the configured storage.  A snapshot already in int8 passes through
        only to an int8 engine."""
        if not snap.dense:
            raise ValueError("the engine scans a page a partition: give it "
                             "a dense snapshot (no page_size)")
        lo, hi = self._block(snap.num_partitions)
        dev = self.device
        cents = snap.centroids[lo:hi].to(dev)
        if snap.scales is not None:
            if self.cfg.storage_dtype != "int8":
                raise ValueError("an int8 snapshot serves only an engine "
                                 "with storage_dtype='int8'")
            data, scales = snap.data[lo:hi].to(dev), snap.scales[lo:hi].to(dev)
        else:
            data, scales = to_storage(
                split_blocks(snap.data[lo:hi].to(dev), cents),
                (hi - lo, *snap.data.shape[1:]),
                STORAGE[self.cfg.storage_dtype], dev)
        return IndexSnapshot(
            data=data, ids=snap.ids[lo:hi].to(dev), centroids=cents,
            sizes=snap.sizes[lo:hi].to(dev),
            beta_table=snap.beta_table.to(dev), scales=scales)

    def refresh_snapshot(self, index) -> IndexSnapshot:
        """This rank's cached block of the dynamic index, kept coherent
        through the index's mutation journal (the batched executor's
        protocol).  A content delta confined to known partitions patches
        only this shard's dirty rows in place; a structural change, a
        delta at int8 storage (rows would need requantizing), capacity
        overflow, too many dirty partitions or a trimmed journal rebuild
        the block.  (The JAX engine rebuilds an int8 block on every call,
        a delta or not; here an unchanged index keeps it, as the batched
        executor does.)"""
        cfg = self.cfg
        if self._snap is not None:
            delta = index.journal.delta_since(self._snap_version)
            if delta is not None and not delta.structural:
                lvl0 = index.levels[0]
                p_real = lvl0.num_partitions
                dirty = sorted(j for j in delta.dirty if j < p_real)
                if not dirty:
                    self._snap_version = index.version
                    return self._snap
                cap = self._snap.capacity
                max_frac = index.config.snapshot_max_dirty_frac
                if (cfg.storage_dtype != "int8"
                        and len(dirty) <= max_frac * max(p_real, 1)
                        and p_real <= self._p_pad
                        and max(len(lvl0.vectors[j]) for j in dirty) <= cap):
                    lo, hi = self._block(self._p_pad)
                    mine = [j for j in dirty if lo <= j < hi]
                    try:
                        patch = IndexSnapshot.build_patch(index, mine, cap)
                    except ValueError:
                        pass
                    else:
                        patch.rows = patch.rows - lo
                        patch.pages = patch.pages - lo
                        # the engine owns its block: patch it in place
                        self._snap = self._snap.apply_delta(patch,
                                                            donate=True)
                        self._host_sizes[dirty] = [len(lvl0.vectors[j])
                                                   for j in dirty]
                        self._snap_version = index.version
                        self.delta_refreshes += 1
                        return self._snap
        self._snap = None        # drop the old block before the new one
        lvl0 = index.levels[0]
        n = self.n_part_shards
        self._p_pad = -(-lvl0.num_partitions // n) * n
        snap = IndexSnapshot.from_index(
            index, headroom=index.config.snapshot_headroom,
            dtype=STORAGE[cfg.storage_dtype], pad_partitions_to=n,
            parts=self._block(self._p_pad), device=self.device)
        self._snap = snap
        self._host_sizes = np.zeros(self._p_pad, dtype=np.int64)
        self._host_sizes[:lvl0.num_partitions] = lvl0.sizes()
        self._snap_version = index.version
        self.full_rebuilds += 1
        return self._snap

    def pad_queries(self, q: Tensor) -> Tensor:
        b = q.shape[0]
        bs = self.n_batch_shards
        bp = ((b + bs - 1) // bs) * bs
        if bp != b:
            q = torch.cat([q, q.new_zeros((bp - b, q.shape[1]))])
        return q

    def _local_queries(self, qp: Tensor) -> Tensor:
        bl = qp.shape[0] // self.n_batch_shards
        b0 = self.batch_index * bl
        return qp[b0:b0 + bl].to(self.device)

    def _gather_batch(self, t: Tensor) -> Tensor:
        return self.mesh.all_gather(t, self._batch_axes, dim=0)

    # ------------------------------------------------------------------
    # shard-local primitives
    # ------------------------------------------------------------------

    def _local_centroid_dists(self, q: Tensor, snap: IndexSnapshot
                              ) -> Tensor:
        """(B_loc, P_loc) centroid distances in minimization convention,
        masked on padding partitions."""
        if self.cfg.metric == "l2":
            d = ref.pairwise_l2_sq(q, snap.centroids)
        else:
            d = -(q @ snap.centroids.T)
        return torch.where(snap.sizes[None, :] > 0, d, MASK_DIST)

    def _scan_selected(self, q: Tensor, snap: IndexSnapshot, sel: Tensor
                       ) -> Tuple[Tensor, Tensor]:
        """The ``"gather"`` scan: ``sel`` (B_loc, n_sel) local partitions
        per query, gathered and scanned per query.  Returns (dists
        (B_loc, n_sel*S), external ids) in minimization convention."""
        if snap.scales is not None:
            raise ValueError(f"the gather scan {INT8_FAULT}")
        b, n = sel.shape
        _, s, d = snap.data.shape
        blocks = snap.data.index_select(0, sel.reshape(-1)).reshape(
            b, n, s, d).float()
        bids = snap.ids.index_select(0, sel.reshape(-1)).reshape(b, n, s)
        if self.cfg.metric == "l2":
            x2 = torch.sum(blocks * blocks, dim=-1)
            qx = torch.einsum("bnsd,bd->bns", blocks, q)
            q2 = torch.sum(q * q, dim=-1)[:, None, None]
            dist = x2 - 2.0 * qx + q2
        else:
            dist = -torch.einsum("bnsd,bd->bns", blocks, q)
        dist = torch.where(bids >= 0, dist, MASK_DIST)
        return dist.reshape(b, -1), bids.reshape(b, -1)

    def _scan_packed(self, q: Tensor, snap: IndexSnapshot, selected: Tensor,
                     k: int, n_union: int,
                     priority: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
        """Packed union scan of a dense ``selected`` (B_loc, P_loc) bool
        probe matrix: ``ops.pack_union`` (frequency-ranked, an optional
        anchor ``priority`` first) and one top-k scan of the union in the
        engine's storage.  Returns (dists (B_loc, k), external ids)
        ascending."""
        cfg = self.cfg
        sel_u, qmask = ops.pack_union(selected, n_union, priority=priority)
        valid = snap.ids >= 0
        if snap.scales is not None:
            d, flat = ops.scan_selected_topk_q8(
                q, snap.data, snap.scales, valid, sel_u, qmask, k,
                metric=cfg.metric, centroids=snap.centroids,
                impl=self._impl)
        else:
            d, flat = ops.scan_selected_topk(
                q, snap.data, valid, sel_u, qmask, k, metric=cfg.metric,
                impl=self._impl)
        ext = snap.ids.reshape(-1)[flat.long().clamp(min=0)]
        return d, torch.where(flat >= 0, ext, -1)

    def _scan_union_topk(self, q: Tensor, snap: IndexSnapshot, sel: Tensor,
                         k: int) -> Tuple[Tensor, Tensor]:
        """Union scan of per-query selections ``sel`` (B_loc, n), best
        first: each selected partition is read once for the whole batch
        (paper §7.4), each query's own probes kept by its mask; column 0,
        each query's nearest local partition, is anchored above the
        frequency ranking.  Returns (dists (B_loc, k), external ids)."""
        b, n_sel = sel.shape
        p_loc = snap.num_partitions
        n_union = min(self.cfg.union_cap or b * n_sel, p_loc)
        selected = torch.zeros((b, p_loc), dtype=torch.bool,
                               device=sel.device)
        selected.scatter_(1, sel, True)
        anchor = torch.zeros(p_loc, dtype=torch.int32, device=sel.device)
        anchor[sel[:, 0]] = 1
        return self._scan_packed(q, snap, selected, k, n_union,
                                 priority=anchor * (b + 1))

    def _merge_global(self, d_loc: Tensor, i_loc: Tensor, k: int
                      ) -> Tuple[Tensor, Tensor]:
        """Hierarchical top-k merge across the partition shards: gather
        every shard's candidates and select again.  Collective volume
        B_loc * shards * k * 8 bytes."""
        axes = self.cfg.part_axes
        dg = self.mesh.all_gather(d_loc, axes, dim=1)
        ig = self.mesh.all_gather(i_loc, axes, dim=1)
        vals, sel = _smallest(dg, k)
        return vals, torch.gather(ig, 1, sel)

    # ------------------------------------------------------------------
    # fixed-nprobe search (static baseline)
    # ------------------------------------------------------------------

    def _search_fixed_local(self, q: Tensor, snap: IndexSnapshot
                            ) -> Tuple[Tensor, Tensor]:
        cfg = self.cfg
        # per-shard probe share, ceil so the union covers >= nprobe
        n_loc = max(1, -(-cfg.nprobe // self.n_part_shards))
        n_loc = min(n_loc, snap.num_partitions)
        _, sel = _smallest(self._local_centroid_dists(q, snap), n_loc)
        if cfg.scan_impl != "gather":
            d_loc, i_loc = self._scan_union_topk(q, snap, sel, cfg.k)
            return self._merge_global(d_loc, i_loc, cfg.k)
        d, i = self._scan_selected(q, snap, sel)
        vals, pos = _smallest(d, min(cfg.k, d.shape[1]))
        d_loc, i_loc = ref.pad_topk(vals, torch.gather(i, 1, pos), cfg.k)
        return self._merge_global(d_loc, i_loc, cfg.k)

    # ------------------------------------------------------------------
    # adaptive search (APS rounds; Algorithm 2)
    # ------------------------------------------------------------------

    def _search_adaptive_local(self, q: Tensor, snap: IndexSnapshot
                               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        cfg, mesh = self.cfg, self.mesh
        axes = cfg.part_axes
        b = q.shape[0]
        p_loc = snap.num_partitions
        chunk = min(cfg.chunk, p_loc)

        cd = self._local_centroid_dists(q, snap)         # (B, P_loc)
        # global nearest centroid distance (for c0 and the margins)
        d0 = mesh.pmin(torch.min(cd, dim=1).values, axes)
        # c0 by a global argmin: the nearest centroids weighted to a total
        # of 1 across all shards, summed
        is_min = (cd <= d0[:, None]).to(q.dtype)
        w = is_min / torch.clamp(mesh.psum(torch.sum(is_min, dim=1), axes),
                                 min=1.0)[:, None]
        c0 = mesh.psum(w @ snap.centroids, axes)         # (B, d)
        cc = torch.sqrt(torch.clamp(ref.pairwise_l2_sq(c0, snap.centroids),
                                    min=1e-12))
        h = (cd - d0[:, None]) / (2.0 * torch.clamp(cc, min=1e-12))
        cand = (snap.sizes[None, :] > 0) & (cd > d0[:, None])

        def recall(rho_sq: Tensor, scanned: Tensor) -> Tensor:
            """Global recall estimate per query (Eqs. 7-9 across shards)."""
            rho = torch.sqrt(torch.clamp(rho_sq, min=1e-30))[:, None]
            v = geometry.cap_fraction(h / rho, snap.beta_table)
            v = torch.where(cand, v, 0.0)
            tot = mesh.psum(torch.sum(v, dim=1), axes)[:, None]
            vn = torch.where(tot > 0, v / torch.clamp(tot, min=1e-20), 0.0)
            log1m = torch.where(
                cand, torch.log1p(-torch.clamp(vn, 0.0, 1.0 - 1e-7)), 0.0)
            p0 = torch.exp(mesh.psum(torch.sum(log1m, dim=1), axes))
            p0 = torch.where(tot[:, 0] > 0, p0, 1.0)
            p = (1.0 - p0[:, None]) * vn
            return p0 + mesh.psum(
                torch.sum(torch.where(scanned, p, 0.0), dim=1), axes)

        def rho_from_topk(td: Tensor) -> Tensor:
            kth = td[:, -1]
            if cfg.metric == "l2":
                return torch.clamp(kth, min=0.0)
            # MIPS: rho^2 in the augmented space, with the max centroid
            # norm standing in for the data's (the JAX engine's choice)
            q2 = torch.sum(q * q, dim=-1)
            m2 = mesh.pmax(torch.max(torch.sum(snap.centroids ** 2, dim=-1))
                           .reshape(1), axes)
            return torch.clamp(q2 + m2 + 2.0 * kth, min=0.0)

        def body(scanned, td, ti):
            # each query's next chunk of unscanned local partitions, in
            # centroid-distance order (probability order for a fixed rho)
            masked = torch.where(scanned, MASK_DIST, cd)
            _, sel = _smallest(masked, chunk)            # (B, chunk)
            scanned = scanned.scatter(1, sel, True)
            if cfg.scan_impl != "gather":
                d, i = self._scan_union_topk(q, snap, sel, cfg.k)
            else:
                d, i = self._scan_selected(q, snap, sel)
            td, ti = ref.merge_topk(td, ti, d, i, cfg.k)
            tdg, _ = self._merge_global(td, ti, cfg.k)
            return scanned, td, ti, recall(rho_from_topk(tdg), scanned)

        scanned = torch.zeros((b, p_loc), dtype=torch.bool, device=q.device)
        td = torch.full((b, cfg.k), MASK_DIST, device=q.device)
        ti = torch.full((b, cfg.k), -1, dtype=torch.int32, device=q.device)
        # round 1 always scans (it initializes rho)
        scanned, td, ti, r = body(scanned, td, ti)
        meta = q.device.type == "meta"
        if meta:
            mesh.notes.append(f"adaptive: {cfg.max_rounds} rounds, the "
                              f"static bound (no data on meta)")
        for _ in range(1, cfg.max_rounds):
            unscanned = mesh.psum(torch.sum(~scanned, dim=1), axes)
            active = (r < cfg.recall_target) & (unscanned > 0)
            # the one host read of a round: every rank of this partition
            # group holds the same all-reduced values, so all agree
            if not meta and not bool(torch.any(active)):
                break
            scanned, td, ti, r = body(scanned, td, ti)
        dg, ig = self._merge_global(td, ti, cfg.k)
        nprobe = mesh.psum(torch.sum(scanned, dim=1), axes)
        return dg, ig, r, nprobe

    # ------------------------------------------------------------------
    # brute force (exact; multi-query policy / ground truth / retrieval)
    # ------------------------------------------------------------------

    def _search_brute_local(self, q: Tensor, snap: IndexSnapshot
                            ) -> Tuple[Tensor, Tensor]:
        if snap.scales is not None:
            raise ValueError(f"search_bruteforce {INT8_FAULT}")
        cfg = self.cfg
        p_loc, s_cap, d = snap.data.shape
        flat = snap.data.reshape(p_loc * s_cap, d)
        fids = snap.ids.reshape(p_loc * s_cap)
        if self._impl == "torch":
            flat = flat.float()  # the oracle takes f32 rows
        dist, pos = ops.scan_topk(q, flat, cfg.k, metric=cfg.metric,
                                  valid=fids >= 0, impl=self._impl)
        ids = torch.where(pos >= 0, fids[pos.long().clamp(min=0)], -1)
        return self._merge_global(dist, ids, cfg.k)

    # ------------------------------------------------------------------
    # public entry points: the whole batch in, the whole batch out
    # ------------------------------------------------------------------

    def _spmd(self, local_fn, q, snap: IndexSnapshot):
        q = torch.as_tensor(q, dtype=torch.float32)
        b = q.shape[0]
        outs = local_fn(self._local_queries(self.pad_queries(q)), snap)
        return tuple(self._gather_batch(o)[:b] for o in outs)

    def search_fixed(self, q, snap: IndexSnapshot) -> Tuple[Tensor, Tensor]:
        """Static-nprobe search of queries ``q`` (B, d): (dists (B, k),
        external ids (B, k)) ascending, on every rank."""
        return self._spmd(self._search_fixed_local, q, snap)

    def search_adaptive(self, q, snap: IndexSnapshot
                        ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """APS rounds (Algorithm 2): (dists, ids, recall estimate (B,),
        partitions scanned (B,))."""
        return self._spmd(self._search_adaptive_local, q, snap)

    def search_bruteforce(self, q, snap: IndexSnapshot
                          ) -> Tuple[Tensor, Tensor]:
        """Exact top-k over every row of the snapshot."""
        return self._spmd(self._search_brute_local, q, snap)

    # ------------------------------------------------------------------
    # planner-driven multi-query entry (shares core.multiquery)
    # ------------------------------------------------------------------

    def _scan_planned(self, qp: Tensor, snap: IndexSnapshot,
                      selected: np.ndarray, anchor: np.ndarray,
                      n_union: int) -> Tuple[Tensor, Tensor]:
        """Scan a planned batch: the padded queries ``qp`` (Bp, d), the
        whole (Bp, P) probe matrix ``selected`` and (P,) ``anchor``; each
        rank packs its own block of them (``n_union`` local slots) and
        scans it once, and the shards' top-k are merged.  Returns the
        whole batch's (dists, external ids), (Bp, k) on every rank."""
        p_loc = snap.num_partitions
        lo = self.part_index * p_loc
        bl = qp.shape[0] // self.n_batch_shards
        b0 = self.batch_index * bl
        dev = self.device
        sel = torch.as_tensor(selected[b0:b0 + bl, lo:lo + p_loc],
                              device=dev)
        prio = torch.as_tensor(anchor[lo:lo + p_loc], device=dev).to(
            torch.int32) * (bl + 1)
        d_loc, i_loc = self._scan_packed(self._local_queries(qp), snap, sel,
                                         self.cfg.k, n_union, priority=prio)
        d, i = self._merge_global(d_loc, i_loc, self.cfg.k)
        return self._gather_batch(d), self._gather_batch(i)

    def _local_union(self, cols: np.ndarray, p_loc: int) -> int:
        """Static per-shard union size: the largest local share of the
        partitions ``cols``, rounded up to a multiple of 8."""
        u_loc = int(np.bincount(cols // p_loc,
                                minlength=self.n_part_shards).max())
        return min(max(-(-max(u_loc, 1) // 8) * 8, 1), p_loc)

    def search_batch(self, index, queries: np.ndarray,
                     k: Optional[int] = None,
                     nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None,
                     union_cap: Optional[int] = None,
                     rounds: Optional[int] = None) -> BatchResult:
        """Multi-query search over the sharded snapshot through the
        batched executor's planner (``multiquery.plan_batch``): per-query
        probe sets are planned once on every rank's host copy of the
        index, scattered into a (B, P) probe matrix, and each rank packs
        and scans its block of it.  APS-planned searches run the
        executor's round loop (``multiquery.run_round_loop``); ``rounds
        =1``, a pinned ``nprobe`` or a ``union_cap`` (defined on the
        whole-batch plan) run one scan.  Returns ``BatchResult``
        (top-``min(k, cfg.k)`` columns)."""
        cfg = self.cfg
        k = cfg.k if k is None else min(k, cfg.k)
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if b == 0:
            return BatchResult(ids=np.zeros((0, k), dtype=np.int64),
                               dists=np.zeros((0, k), dtype=np.float64),
                               nprobe=np.zeros(0, dtype=np.int64))
        snap = self.refresh_snapshot(index)
        if self._planner_cache is None or \
                self._planner_cache.index is not index:
            self._planner_cache = PlannerCache(index)
        pc = self._planner_cache.ensure_fresh()
        cap = union_cap if union_cap is not None else cfg.union_cap
        rounds = cfg.rounds if rounds is None else rounds
        if rounds is not None and rounds < 1:
            raise ValueError(f"rounds must be >= 1 or None, got {rounds}")
        if nprobe is None and rounds != 1 and cap is None:
            target = recall_target if recall_target is not None \
                else index.config.recall_target
            return self._search_batch_rounds(index, q, k, target, rounds,
                                             snap, pc)
        # the union cap caps the plan, as in the executor, so the stats
        # and the effective nprobe reflect what was scanned
        plan = plan_batch(index, q, k, nprobe=nprobe,
                          recall_target=recall_target, union_cap=cap,
                          cent_norms=pc._cent_norms, cache=pc)
        qp = self.pad_queries(torch.as_tensor(q))
        p_pad = self._p_pad
        sel_cols = plan.sel[:plan.n_real]
        selected = np.zeros((qp.shape[0], p_pad), dtype=bool)
        selected[np.ix_(np.arange(b), sel_cols)] = \
            plan.qmask[:, :plan.n_real]
        anchor = np.zeros(p_pad, dtype=bool)
        anchor[plan.anchor] = True
        d, ids = self._scan_planned(
            qp, snap, selected, anchor,
            self._local_union(sel_cols, snap.num_partitions))
        # quakecheck: allow-sync(result boundary: BatchResult is a host contract)
        d = to_host(d.double())[:b, :k]
        ids = to_host(ids)[:b, :k]  # quakecheck: allow-sync(result boundary)
        d = np.where(d >= MASK_DIST, np.inf, d)
        ids = np.where(np.isinf(d), -1, ids)
        sizes = self._host_sizes[sel_cols]
        return BatchResult(
            ids=ids.astype(np.int64), dists=d,
            partitions_scanned=int(plan.n_real),
            vectors_scanned=int(sizes.sum()),
            comparisons=int((plan.qmask[:, :plan.n_real].astype(np.int64)
                             * sizes[None, :]).sum()),
            nprobe=plan.nprobe, recall_estimate=plan.recall_est)

    def _search_batch_rounds(self, index, q: np.ndarray, k: int,
                             target: float, rounds: Optional[int],
                             snap: IndexSnapshot, pc) -> BatchResult:
        """The engine side of the executor's Algorithm-2 round loop: each
        round scatters the live queries' next probe window into the (B,
        P) probe matrix and scans it planned (per-shard pack, scan,
        global merge); the shared round loop keeps the running top-k, the
        refined recall estimate and the live mask."""
        b = q.shape[0]
        rplan = plan_rounds(index, q, k, target, cache=pc,
                            cent_norms=pc._cent_norms)
        qp = self.pad_queries(torch.as_tensor(q))
        bp = qp.shape[0]
        p_pad = self._p_pad
        rr = np.broadcast_to(np.arange(b)[:, None], rplan.seq.shape)
        anchor = np.zeros(p_pad, dtype=bool)     # uncapped: no priority

        def scan_round(take, kept):
            selected = np.zeros((bp, p_pad), dtype=bool)
            selected[rr[take], rplan.seq[take]] = True
            d, ids = self._scan_planned(
                qp, snap, selected, anchor,
                self._local_union(kept, snap.num_partitions))
            st = {"partitions": int(len(kept)),
                  "vectors": int(self._host_sizes[kept].sum()),
                  "comparisons": int(
                      self._host_sizes[rplan.seq[take]].sum())}
            return d[:b], ids[:b], st

        td, ti, nprobe, r_est, n_rounds, trace, stats = run_round_loop(
            rplan, k, target, index._beta_table, _batch_rho_fn(index, q),
            scan_round, rounds=rounds, k_keep=self.cfg.k,
            device=self.device)
        # quakecheck: allow-sync(result boundary: BatchResult is a host contract)
        dd = to_host(td.double())[:, :k]
        ids = to_host(ti)[:, :k]  # quakecheck: allow-sync(result boundary)
        dd = np.where(dd >= MASK_DIST, np.inf, dd)
        ids = np.where(np.isinf(dd), -1, ids)
        return BatchResult(
            ids=ids.astype(np.int64), dists=dd,
            partitions_scanned=stats["partitions"],
            vectors_scanned=stats["vectors"],
            comparisons=stats["comparisons"],
            nprobe=nprobe, recall_estimate=r_est,
            rounds=n_rounds, round_trace=trace)
