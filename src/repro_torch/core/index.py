"""Quake's multi-level partitioned index (paper §3) — the dynamic engine.

The partition directory (ragged inverted lists, id maps, statistics) is a
host-side control plane in numpy, as in the JAX package; k-means,
routing and the batched executor's snapshot and scans run on the index's
``device``.  Entry points default to ``device="cuda"`` and raise when
CUDA is absent unless the caller asks for ``device="cpu"``.

Per-query ``search`` scans ragged partitions through ``config.scan_impl``:
  * ``auto``  — ``cuda`` on a CUDA index, ``numpy`` on a CPU one (default);
  * ``numpy`` — BLAS matmul + argpartition on the host;
  * ``torch`` — the plain oracle on the index's device;
  * ``cuda``  — the kernel path (the CUDA kernel on the card).

Level structure: level 0 partitions hold data vectors; level ``l``
partitions group the centroids of level ``l-1``.  Search walks top-down,
running APS at every level.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from . import aps as aps_mod
from . import geometry, kmeans
from .cost_model import PartitionStats
from .device import resolve_device
from .journal import MutationJournal

__all__ = ["QuakeConfig", "QuakeIndex", "Level", "SearchResult",
           "resolve_device"]


@dataclass
class QuakeConfig:
    metric: str = "l2"                  # "l2" | "ip"
    f_m: float = 0.05                   # base-level initial candidate fraction
    f_m_upper: float = 0.25             # candidate fraction at upper levels
    min_candidates: int = 32            # floor on the APS candidate set
    recall_target: float = 0.9
    recall_target_upper: float = 0.99   # fixed for higher levels (paper §5.1)
    tau_rho: float = 0.01               # radius recompute threshold
    scan_impl: str = "auto"             # auto | numpy | torch | cuda
    enable_aps: bool = True             # ablation: static nprobe when False
    fixed_nprobe: int = 16              # used when enable_aps=False
    # --- maintenance (paper §8.1; the JAX package's defaults) ---
    tau_ns: float = 2.0                 # commit threshold tau; the paper's
                                        # 250 ns rescaled to a profiled
                                        # lambda is cost_model.paper_tau_ns
    alpha: float = 0.9                  # split access-scaling
    refine_radius: int = 50             # r_f
    refine_iters: int = 1
    min_partition_size: int = 32        # merge candidates below this size
    default_access_freq: float = 0.05   # prior before stats exist
    # --- levels ---
    level_add_threshold: int = 4096     # add a top level when N_top exceeds
    level_remove_threshold: int = 64    # drop the top level when N_top below
    # --- snapshot refresh (delta path, paper §8.2) ---
    snapshot_headroom: float = 1.5     # slack on snapshot slot capacity
    snapshot_max_dirty_frac: float = 0.5  # delta-refresh while dirty
                                        # partitions <= frac * P
    # --- batched executor (multiquery.py) ---
    union_cap: Optional[int] = None     # max distinct partitions per batch
    planner_radius_ttl: int = 64        # reuses of a calibrated radius
    seed: int = 0


@dataclass
class Level:
    """One level of the hierarchy.  Level 0 stores data vectors, upper
    levels store child partition-index lists."""
    centroids: np.ndarray                       # (P, d) float32
    vectors: Optional[List[np.ndarray]] = None  # level 0: (s_j, d) each
    ids: Optional[List[np.ndarray]] = None      # level 0: external ids
    sqnorms: Optional[List[np.ndarray]] = None  # level 0: cached ||x||^2
    children: Optional[List[np.ndarray]] = None  # level>0: level-1 part idx
    parent: Optional[np.ndarray] = None         # partition idx at level+1
    stats: PartitionStats = field(default_factory=PartitionStats)

    @property
    def num_partitions(self) -> int:
        return self.centroids.shape[0]

    def partition_size(self, j: int) -> int:
        store = self.vectors if self.vectors is not None else self.children
        return len(store[j])

    def sizes(self) -> np.ndarray:
        store = self.vectors if self.vectors is not None else self.children
        return np.asarray([len(s) for s in store])

    def sizes_of(self, idx) -> np.ndarray:
        """Sizes of just the given partitions."""
        store = self.vectors if self.vectors is not None else self.children
        return np.asarray([len(store[j]) for j in np.asarray(idx).ravel()])


@dataclass
class SearchResult:
    ids: np.ndarray
    dists: np.ndarray          # minimization convention (-score for ip)
    nprobe: Dict[int, int]     # partitions scanned per level
    recall_estimate: float
    vectors_scanned: int = 0

    @property
    def scores(self) -> np.ndarray:
        return -self.dists


def _group_by(assign: np.ndarray, n_groups: int) -> List[np.ndarray]:
    """Row indices of each group, in original row order (what
    ``np.where(assign == j)`` gives for every j, in one sort)."""
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(n_groups + 1))
    return [order[bounds[j]:bounds[j + 1]] for j in range(n_groups)]


class QuakeIndex:
    """Dynamic multi-level partitioned ANN index with APS search."""

    def __init__(self, dim: int, config: Optional[QuakeConfig] = None,
                 device="cuda"):
        self.dim = dim
        self.config = config or QuakeConfig()
        self.device = resolve_device(device)
        self.levels: List[Level] = []
        self.id_map: Dict[int, int] = {}     # external id -> level-0 partition
        self.journal = MutationJournal()
        self._rng = np.random.default_rng(self.config.seed)
        self.geometry_dim = dim if self.config.metric == "l2" else dim + 1
        self._beta_table = geometry.betainc_table(self.geometry_dim)
        self._max_norm_sq = 1e-12           # MIPS augmentation constant M^2
        self._aug_extra: List[Optional[np.ndarray]] = []
        self.maintenance_log: List[dict] = []

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, x: np.ndarray, ids: Optional[np.ndarray] = None,
              num_partitions: Optional[int] = None,
              level_sizes: Optional[Sequence[int]] = None,
              config: Optional[QuakeConfig] = None,
              kmeans_iters: int = 10, device="cuda") -> "QuakeIndex":
        """Build from data.  ``num_partitions`` defaults to sqrt(n) (paper
        §7.2); ``level_sizes`` optionally gives upper-level counts."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        n, dim = x.shape
        idx = cls(dim, config, device=device)
        if ids is None:
            ids = np.arange(n, dtype=np.int64)
        ids = np.asarray(ids, dtype=np.int64)
        if level_sizes is None:
            p0 = num_partitions or max(1, int(round(math.sqrt(n))))
            level_sizes = (p0,)
        idx._max_norm_sq = max(float(np.max(np.sum(
            x.astype(np.float64) ** 2, axis=1), initial=0.0)), 1e-12)

        p0 = min(level_sizes[0], n)
        cents, assign = kmeans.kmeans(x, p0, iters=kmeans_iters,
                                      seed=idx.config.seed,
                                      device=idx.device)
        groups = _group_by(assign, p0)
        vectors = [np.ascontiguousarray(x[g]) for g in groups]
        vids = [ids[g] for g in groups]
        idx.levels.append(Level(
            centroids=cents, vectors=vectors, ids=vids,
            sqnorms=[np.sum(v.astype(np.float64) ** 2, axis=1)
                     .astype(np.float32) for v in vectors]))
        idx.id_map = dict(zip(ids.tolist(), assign.tolist()))

        for p_l in level_sizes[1:]:
            idx._add_level_from(p_l, kmeans_iters)
        idx._aug_extra = [None] * len(idx.levels)
        return idx

    def _add_level_from(self, p_l: int, iters: int = 10) -> None:
        below = self.levels[-1]
        p_l = min(p_l, below.centroids.shape[0])
        cents, assign = kmeans.kmeans(below.centroids, p_l, iters=iters,
                                      seed=self.config.seed + len(self.levels),
                                      device=self.device)
        children = [g.astype(np.int64) for g in _group_by(assign, p_l)]
        below.parent = assign.astype(np.int64)
        self.levels.append(Level(centroids=cents, children=children))
        self._aug_extra = [None] * len(self.levels)
        self.journal.record(reason="level_add")

    def remove_top_level(self) -> None:
        """Drop the top level (paper §4.2.1 Remove Level): the level below
        is then scanned fully at query time."""
        assert len(self.levels) >= 2
        self.levels.pop()
        self.levels[-1].parent = None
        self._aug_extra = [None] * len(self.levels)
        self.journal.record(reason="level_remove")

    # ------------------------------------------------------------------
    # Metric helpers
    # ------------------------------------------------------------------

    def _centroid_geo_dists(self, q: np.ndarray, level_idx: int,
                            part_ids: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """(geometry-space squared distances (M,), scan-order keys): both
        ||q-c||^2 for L2; MIPS-augmented distances and -s for IP."""
        c = self.levels[level_idx].centroids[part_ids]
        if self.config.metric == "l2":
            d = (np.sum(q * q) + np.sum(c * c, axis=1) - 2.0 * (c @ q))
            d = np.maximum(d, 0.0)
            return d, d
        s = c @ q
        geo = np.maximum(np.sum(q * q) + self._max_norm_sq - 2.0 * s, 0.0)
        return geo, -s

    def _centroid_cc_dists(self, level_idx: int, part_ids: np.ndarray,
                           nearest_local: int) -> np.ndarray:
        """||c_i - c_0|| in geometry space (augmented for IP)."""
        c = self.levels[level_idx].centroids[part_ids].astype(np.float64)
        c0 = c[nearest_local]
        d2 = np.sum((c - c0) ** 2, axis=1)
        if self.config.metric == "ip":
            e = self._augment_extra(level_idx)[part_ids]
            d2 = d2 + (e - e[nearest_local]) ** 2
        return np.sqrt(np.maximum(d2, 0.0))

    def _augment_extra(self, level_idx: int) -> np.ndarray:
        cached = self._aug_extra[level_idx]
        c = self.levels[level_idx].centroids
        if cached is None or len(cached) != c.shape[0]:
            n2 = np.sum(c.astype(np.float64) ** 2, axis=1)
            cached = np.sqrt(np.maximum(self._max_norm_sq - n2, 0.0))
            self._aug_extra[level_idx] = cached
        return cached

    def _rho_sq_from_item_dist(self, q_norm_sq: float):
        if self.config.metric == "l2":
            return lambda kth: max(kth, 0.0)
        m2 = self._max_norm_sq
        return lambda kth: max(q_norm_sq + m2 + 2.0 * kth, 0.0)

    # ------------------------------------------------------------------
    # Scanning backends
    # ------------------------------------------------------------------

    def _scan_vectors(self, q: np.ndarray, x: np.ndarray,
                      x2: Optional[np.ndarray], item_ids: np.ndarray,
                      k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Scan a ragged buffer; returns (dists, ids) of its top-min(k, s)."""
        impl = self.config.scan_impl
        if impl == "auto":
            impl = "cuda" if self.device.type == "cuda" else "numpy"
        if impl == "numpy":
            if self.config.metric == "l2":
                if x2 is None:
                    x2 = np.sum(x * x, axis=1)
                d = x2 - 2.0 * (x @ q) + np.sum(q * q)
            else:
                d = -(x @ q)
            if len(d) > k:
                sel = np.argpartition(d, k - 1)[:k]
                return d[sel], item_ids[sel]
            return d, item_ids
        dd, ii = ops.scan_topk(
            torch.as_tensor(q[None, :], device=self.device),
            torch.as_tensor(x, device=self.device), min(k, x.shape[0]),
            metric=self.config.metric, impl=impl)
        dd = dd[0].cpu().numpy()
        ii = ii[0].cpu().numpy()
        keep = ii >= 0
        return dd[keep], item_ids[ii[keep]]

    def _scan_level_partition(self, q: np.ndarray, level_idx: int, j: int,
                              k: int) -> Tuple[np.ndarray, np.ndarray]:
        level = self.levels[level_idx]
        if level.vectors is not None:
            return self._scan_vectors(q, level.vectors[j], level.sqnorms[j],
                                      level.ids[j], k)
        child = level.children[j]
        below = self.levels[level_idx - 1]
        return self._scan_vectors(q, below.centroids[child], None, child, k)

    # ------------------------------------------------------------------
    # Search (paper §5)
    # ------------------------------------------------------------------

    def search(self, q: np.ndarray, k: int,
               recall_target: Optional[float] = None,
               nprobe: Optional[int] = None,
               record_stats: bool = True) -> SearchResult:
        """Per-query APS search.  ``nprobe`` (or config.enable_aps=False)
        switches to a fixed number of base-level probes."""
        q = np.ascontiguousarray(q, dtype=np.float32).reshape(-1)
        cfg = self.config
        target = recall_target if recall_target is not None else \
            cfg.recall_target
        q_norm_sq = float(np.sum(q.astype(np.float64) ** 2))
        rho_fn = self._rho_sq_from_item_dist(q_norm_sq)

        L = len(self.levels)
        top = self.levels[-1]
        cand = np.arange(top.num_partitions)
        cand_geo, _ = self._centroid_geo_dists(q, L - 1, cand)
        nprobe_per_level: Dict[int, int] = {}
        vectors_scanned = 0

        for l in range(L - 1, -1, -1):
            level = self.levels[l]
            if l == 0:
                k_l, tgt, f_m = k, target, cfg.f_m
            else:
                below_n = self.levels[l - 1].num_partitions
                f_m_below = cfg.f_m if l - 1 == 0 else cfg.f_m_upper
                k_l = max(k, int(math.ceil(f_m_below * below_n)))
                tgt, f_m = cfg.recall_target_upper, cfg.f_m_upper
            n_consider = max(int(math.ceil(f_m * level.num_partitions)),
                             cfg.min_candidates)
            use_aps = cfg.enable_aps and nprobe is None
            if not use_aps and l == 0:
                n_consider = max(n_consider,
                                 nprobe if nprobe is not None
                                 else cfg.fixed_nprobe)
            n_consider = min(max(n_consider, 1), len(cand))
            if n_consider < len(cand):
                sel = np.argpartition(cand_geo, n_consider - 1)[:n_consider]
                cand, cand_geo = cand[sel], cand_geo[sel]
            nearest_local = int(np.argmin(cand_geo))
            cc = self._centroid_cc_dists(l, cand, nearest_local)

            sizes = level.sizes()
            scanned_count = [0]

            def scan_fn(m: int, _l=l, _cand=cand, _k=k_l, _sc=scanned_count):
                _sc[0] += int(sizes[_cand[m]])
                return self._scan_level_partition(q, _l, int(_cand[m]), _k)

            if use_aps:
                res = aps_mod.aps_scan(
                    cand_centroid_dists_sq=cand_geo, cand_cc_dists=cc,
                    scan_partition=scan_fn, item_dist_to_rho_sq=rho_fn,
                    k=k_l, recall_target=tgt, table=self._beta_table,
                    tau_rho=cfg.tau_rho)
            else:
                n_fixed = nprobe if nprobe is not None else cfg.fixed_nprobe
                res = self._fixed_scan(cand_geo, scan_fn, k_l,
                                       min(n_fixed, len(cand)))
            vectors_scanned += scanned_count[0]
            nprobe_per_level[l] = res.nprobe
            if record_stats:
                level.stats.ensure(level.num_partitions)
                level.stats.record(cand[res.scanned])
            if l == 0:
                keep = res.ids >= 0
                return SearchResult(ids=res.ids[keep], dists=res.dists[keep],
                                    nprobe=nprobe_per_level,
                                    recall_estimate=res.recall_estimate,
                                    vectors_scanned=vectors_scanned)
            keep = res.ids >= 0
            cand = res.ids[keep].astype(np.int64)
            if cfg.metric == "l2":
                cand_geo = np.maximum(res.dists[keep], 0.0)
            else:
                cand_geo = np.maximum(
                    q_norm_sq + self._max_norm_sq + 2.0 * res.dists[keep],
                    0.0)
            if len(cand) == 0:  # degenerate hierarchy: full set
                cand = np.arange(self.levels[l - 1].num_partitions)
                cand_geo, _ = self._centroid_geo_dists(q, l - 1, cand)
        raise AssertionError("unreachable")

    def search_batch(self, queries: np.ndarray, k: int,
                     nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None,
                     impl: str = "auto",
                     union_cap: Optional[int] = None,
                     storage_dtype: Optional[str] = None,
                     rounds: Optional[int] = None):
        """Batched multi-query search (paper §7.4) through the executor
        (``multiquery.batch_search``): APS-planned per-query probe sets
        run as multi-round early-exit probe rounds (Algorithm 2), each a
        packed partition-union scan on the index's device.  ``rounds=1``
        forces one fixed-plan scan; ``storage_dtype`` is "f32", "bf16" or
        "int8" (IVF-residual codes, re-ranked exactly).
        Returns ``multiquery.BatchResult``."""
        from .multiquery import batch_search  # late: avoid import cycle
        return batch_search(self, queries, k, nprobe=nprobe,
                            recall_target=recall_target, impl=impl,
                            union_cap=union_cap,
                            storage_dtype=storage_dtype, rounds=rounds)

    @staticmethod
    def _fixed_scan(cand_geo, scan_fn, k, n_fixed) -> aps_mod.APSResult:
        order = np.argsort(cand_geo, kind="stable")[:max(n_fixed, 1)]
        heap = aps_mod.TopK(k)
        for m in order:
            d, i = scan_fn(int(m))
            heap.update(d, i)
        return aps_mod.APSResult(ids=heap.ids, dists=heap.dists,
                                 scanned=np.asarray(order),
                                 nprobe=len(order), recall_estimate=np.nan)

    # ------------------------------------------------------------------
    # Updates (paper §3, data path)
    # ------------------------------------------------------------------

    def _route_to_base(self, x: np.ndarray) -> np.ndarray:
        """Vectorized top-down routing to the nearest base partition."""
        L = len(self.levels)
        n = x.shape[0]
        dev = self.device
        if L == 1:
            return kmeans.assign(x, self.levels[0].centroids, device=dev)
        cur = kmeans.assign(x, self.levels[-1].centroids,
                            device=dev).astype(np.int64)
        for l in range(L - 1, 0, -1):
            level = self.levels[l]
            below = self.levels[l - 1]
            nxt = np.empty(n, dtype=np.int64)
            for p in np.unique(cur):
                sel = np.where(cur == p)[0]
                child = level.children[p]
                if len(child) == 0:  # empty group: global fallback
                    nxt[sel] = kmeans.assign(x[sel], below.centroids,
                                             device=dev)
                    continue
                sub = kmeans.assign(x[sel], below.centroids[child],
                                    device=dev)
                nxt[sel] = child[sub]
            cur = nxt
        return cur

    def insert(self, x: np.ndarray, ids: np.ndarray) -> None:
        x = np.ascontiguousarray(x, dtype=np.float32)
        ids = np.asarray(ids, dtype=np.int64)
        if x.ndim != 2 or x.shape[1] != self.dim or ids.shape != (len(x),):
            raise ValueError(f"insert takes x (n, {self.dim}) and ids (n,),"
                             f" got {x.shape} and {ids.shape}")
        if x.shape[0] == 0:
            return
        self._max_norm_sq = max(self._max_norm_sq, float(np.max(
            np.sum(x.astype(np.float64) ** 2, axis=1), initial=0.0)))
        self._aug_extra = [None] * len(self.levels)
        assign = self._route_to_base(x)
        self.journal.record(dirty=np.unique(assign), reason="insert")
        lvl0 = self.levels[0]
        for j in np.unique(assign):
            sel = assign == j
            lvl0.vectors[j] = np.concatenate([lvl0.vectors[j], x[sel]])
            lvl0.ids[j] = np.concatenate([lvl0.ids[j], ids[sel]])
            lvl0.sqnorms[j] = np.concatenate(
                [lvl0.sqnorms[j],
                 np.sum(x[sel].astype(np.float64) ** 2, 1).astype(np.float32)])
        self.id_map.update(zip(ids.tolist(), assign.tolist()))

    def delete(self, ids: np.ndarray) -> int:
        """Delete by external id with immediate compaction; returns the
        number removed."""
        ids = np.asarray(ids, dtype=np.int64)
        by_part: Dict[int, list] = {}
        removed = 0
        for ext in ids:
            j = self.id_map.pop(int(ext), None)
            if j is not None:
                by_part.setdefault(j, []).append(int(ext))
        if by_part:
            self.journal.record(dirty=by_part.keys(), reason="delete")
        lvl0 = self.levels[0]
        for j, exts in by_part.items():
            mask = ~np.isin(lvl0.ids[j], np.asarray(exts, dtype=np.int64))
            removed += int((~mask).sum())
            lvl0.vectors[j] = np.ascontiguousarray(lvl0.vectors[j][mask])
            lvl0.ids[j] = lvl0.ids[j][mask]
            lvl0.sqnorms[j] = lvl0.sqnorms[j][mask]
        return removed

    # ------------------------------------------------------------------
    # Durability (core/durability.py)
    # ------------------------------------------------------------------

    def save(self, root: str) -> dict:
        """Durable save: a full atomic checkpoint under ``root`` (the next
        free generation, CRC-manifested, fingerprinted), in the JAX
        package's byte format.  Returns the manifest.  ``root`` may
        already hold a WAL and older generations; the new checkpoint
        supersedes them."""
        from .durability import save_index  # late: avoid import cycle
        return save_index(self, root)

    @classmethod
    def load(cls, root: str, device="cuda") -> "QuakeIndex":
        """Load the newest valid checkpoint under ``root``, replay any WAL
        suffix and verify the stored fingerprint
        (``durability.recover_index``); the index lives on ``device``.
        Raises ``durability.RecoveryError`` when nothing valid
        survives."""
        from .durability import recover_index  # late: avoid import cycle
        idx, _report = recover_index(root, device=device)
        return idx

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def version(self) -> int:
        """Monotonic mutation clock, backed by the journal."""
        return self.journal.version

    @property
    def num_vectors(self) -> int:
        return sum(len(v) for v in self.levels[0].vectors)

    @property
    def num_partitions(self) -> int:
        return self.levels[0].num_partitions

    def check_invariants(self) -> None:
        """Structural invariants (raise AssertionError on a violation)."""
        lvl0 = self.levels[0]
        assert len(lvl0.vectors) == len(lvl0.ids) == lvl0.num_partitions
        for v, i, s in zip(lvl0.vectors, lvl0.ids, lvl0.sqnorms):
            assert v.shape[0] == i.shape[0] == s.shape[0]
            assert v.shape[1] == self.dim
        all_ids = np.concatenate([i for i in lvl0.ids]) if \
            lvl0.num_partitions else np.zeros(0)
        assert len(all_ids) == len(set(all_ids.tolist())) == len(self.id_map)
        for ext, j in self.id_map.items():
            assert 0 <= j < lvl0.num_partitions
        for l in range(1, len(self.levels)):
            level = self.levels[l]
            below = self.levels[l - 1]
            below_n = below.num_partitions
            seen = np.concatenate([c for c in level.children]) if \
                level.num_partitions else np.zeros(0, dtype=np.int64)
            assert len(seen) == below_n, (len(seen), below_n)
            assert len(np.unique(seen)) == below_n
            if len(seen):
                assert seen.min() >= 0 and seen.max() < below_n
            assert below.parent is not None and len(below.parent) == below_n
            for pj in range(level.num_partitions):
                assert (below.parent[level.children[pj]] == pj).all()
