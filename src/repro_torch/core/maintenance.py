"""Adaptive incremental maintenance (paper §4).

Bottom-up pass over the hierarchy; per level the five stages:

  Stage 0  statistics are tracked continuously by the index (sizes + access
           frequencies over the sliding window W),
  Stage 1  *estimate*: Δ'Split (Eq. 6) / Δ'Merge (uniform-redistribution
           Eq. 5) for every partition; actions with Δ' < -τ become tentative,
  Stage 2  *verify*: the action's outcome is computed (2-means child sizes /
           actual receiver sets) and the exact Δ (Eqs. 4/5) re-evaluated with
           measured sizes but Stage-1 frequency assumptions,
  Stage 3  *commit / reject*: commit iff Δ < -τ — this is what makes total
           cost monotonically non-increasing under a fixed workload,
  Stage 4  propagate to level l+1.

Our verify is *virtual*: the split assignment / receiver assignment is
computed without mutating the index, the exact Δ evaluated, and only a commit
mutates — semantically identical to apply-then-rollback but cheaper.

Split commits are followed by partition refinement (k-means seeded with
current centroids over the r_f neighboring partitions, paper §4.2.1), whose
cost-model effect is intentionally unmodeled (captured by future statistics).
The report's ``unpriced_cost`` (a field the JAX package's report does not
have) sums the cost changes that the commit gate does not price
(refinement and level add/remove), so that ``cost_after - unpriced_cost -
cost_before`` is the sum of the committed actions' verify deltas;
``cost_after`` itself may rise above ``cost_before`` when refinement moves
points, as in the reference.

Device work: the 2-means of a split, the Lloyd step of refinement and the
receiver assignment of a merge verify run on the index's device
(``kmeans.split_two`` / ``refine`` / ``assign``; on a CUDA index the
assignment is the ``kmeans_assign`` kernel).  Everything else is host
numpy, as in the JAX package, which this module ports.

Generalization note: the paper's centroid-overhead term ΔO± = λ(N_l ± 1) −
λ(N_l) treats the centroid list as one flat scan.  With a parent level
present the new centroid lands in a specific parent partition; we charge
A_parent · (λ(s_parent ± 1) − λ(s_parent)) instead, which reduces exactly to
the paper's formula in the single-level case (implicit top: A = 1,
s = N_l).
"""
from __future__ import annotations

import copy
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.tracing import count, span
from . import cost_model as cm
from . import kmeans
from .cost_model import LatencyModel
from .index import Level, QuakeIndex

__all__ = ["Maintainer", "MaintenanceReport", "MaintenancePolicy",
           "checkpoint_index", "restore_index"]


# ---------------------------------------------------------------------------
# Crash recovery: checkpoint / restore around a maintenance pass
# ---------------------------------------------------------------------------

def checkpoint_index(index: QuakeIndex) -> dict:
    """Deep snapshot of everything a maintenance pass may mutate, so a
    crash mid-recluster (split/merge committed, pass not finished) can
    roll back to exactly the pre-pass state — including the journal, so
    ``index.version`` is unchanged and snapshot/cache consumers keyed on
    it stay coherent.  Levels hold numpy containers plus
    ``PartitionStats``; ``copy.deepcopy`` covers both."""
    j = index.journal
    return {
        "levels": copy.deepcopy(index.levels),
        "id_map": dict(index.id_map),
        "max_norm_sq": index._max_norm_sq,
        "maintenance_log_len": len(index.maintenance_log),
        "journal_version": j.version,
        "journal_entries": list(j._entries),
        "journal_floor": j._floor,
        "journal_overflowed": j.overflowed,
        "journal_overflow_count": j.overflow_count,
    }


def restore_index(index: QuakeIndex, ckpt: dict) -> None:
    """Roll the index back to a :func:`checkpoint_index` state."""
    index.levels = ckpt["levels"]
    index.id_map = ckpt["id_map"]
    index._max_norm_sq = ckpt["max_norm_sq"]
    del index.maintenance_log[ckpt["maintenance_log_len"]:]
    index._aug_extra = [None] * len(index.levels)
    j = index.journal
    j.version = ckpt["journal_version"]
    j._entries = deque(ckpt["journal_entries"])
    j._floor = ckpt["journal_floor"]
    # .get: tolerate pre-overflow-flag checkpoints (dicts are in-process
    # only, but restore must not KeyError on one taken before the flag
    # existed in a mixed-version test)
    j.overflowed = ckpt.get("journal_overflowed", j.overflowed)
    j.overflow_count = ckpt.get("journal_overflow_count", j.overflow_count)


@dataclass
class MaintenancePolicy:
    """Ablation switches (paper Table 7 variants)."""
    use_cost_model: bool = True     # False -> size-threshold policy (NoCost)
    use_refinement: bool = True     # False -> NoRef
    use_rejection: bool = True      # False -> NoRej (skip verify gate)
    split_size_threshold: float = 2.0   # NoCost: split if size > thr * mean
    merge_size_threshold: float = 0.2   # NoCost: merge if size < thr * mean


@dataclass
class MaintenanceReport:
    cost_before: float = 0.0
    cost_after: float = 0.0
    splits: int = 0
    merges: int = 0
    rejected_splits: int = 0
    rejected_merges: int = 0
    level_added: bool = False
    level_removed: bool = False
    actions: List[dict] = field(default_factory=list)
    unpriced_cost: float = 0.0      # cost change of refinement and level
                                    # add/remove (not priced by the gate)


class Maintainer:
    """Drives maintenance for a QuakeIndex against a latency model."""

    def __init__(self, index: QuakeIndex, lam: Optional[LatencyModel] = None,
                 policy: Optional[MaintenancePolicy] = None):
        self.index = index
        self.lam = lam or LatencyModel(dim=index.dim)
        self.policy = policy or MaintenancePolicy()
        # optional faults.FaultInjector: when set, every committed split
        # or merge is an arrival at the "maintenance" site, so a chaos
        # run crashes the pass after the index has mutated; the serving
        # runtime's checkpoint/rollback makes that survivable
        self.faults = None

    # ------------------------------------------------------------------
    # Cost accounting
    # ------------------------------------------------------------------

    def level_freqs(self, l: int) -> np.ndarray:
        level = self.index.levels[l]
        return level.stats.access_freq(level.num_partitions,
                                       self.index.config.default_access_freq)

    def total_cost(self) -> float:
        """Paper Eq. (2) over all levels, plus the implicit top scan."""
        idx = self.index
        c = 0.0
        for l, level in enumerate(idx.levels):
            c += float(np.sum(self.level_freqs(l)
                              * self.lam(level.sizes())))
        c += float(self.lam(idx.levels[-1].num_partitions))  # top centroids
        return c

    def _parent_overhead(self, l: int, delta: int) -> float:
        """A_parent * (λ(s_p + delta) - λ(s_p)); implicit top if l is top."""
        idx = self.index
        if l == len(idx.levels) - 1:
            n = idx.levels[l].num_partitions
            return float(self.lam(n + delta) - self.lam(n))
        # charge the *average* parent (estimate stage doesn't know which);
        # verify uses the actual parent
        parent_level = idx.levels[l + 1]
        freqs = self.level_freqs(l + 1)
        sizes = parent_level.sizes()
        return float(np.mean(freqs * (self.lam(sizes + delta)
                                      - self.lam(sizes))))

    def _parent_overhead_exact(self, l: int, j: int, delta: int) -> float:
        idx = self.index
        if l == len(idx.levels) - 1:
            n = idx.levels[l].num_partitions
            return float(self.lam(n + delta) - self.lam(n))
        p = int(idx.levels[l].parent[j])
        s = idx.levels[l + 1].partition_size(p)
        a = float(self.level_freqs(l + 1)[p])
        return a * float(self.lam(s + delta) - self.lam(s))

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def run(self, reset_stats: bool = True) -> MaintenanceReport:
        """One pass over every level: a ``quake.maintenance`` span, with
        its splits and merges counted, while the profiler records."""
        with span("maintenance"):
            rep = self._pass(reset_stats)
            count("maintenance.splits", rep.splits)
            count("maintenance.merges", rep.merges)
            return rep

    def _pass(self, reset_stats: bool) -> MaintenanceReport:
        idx = self.index
        version_before = idx.version
        rep = MaintenanceReport(cost_before=self.total_cost())
        for l in range(len(idx.levels)):
            self._run_level(l, rep)
        c0 = self.total_cost()
        self._maybe_adjust_levels(rep)
        rep.cost_after = self.total_cost()
        rep.unpriced_cost += rep.cost_after - c0
        # Snapshot invalidation rides on the journal entries written by the
        # committed actions themselves (split/merge/refine/level) — a pass
        # where nothing commits leaves the version clock untouched and no
        # consumer rebuilds anything.
        if reset_stats:
            for level in idx.levels:
                level.stats.reset()
        idx.maintenance_log.append(rep.__dict__ | {
            "partitions": [lv.num_partitions for lv in idx.levels],
            "version": idx.version,
            "journal": [{"version": e.version, "reason": e.reason,
                         "structural": e.structural,
                         "dirty": sorted(e.dirty)}
                        for e in idx.journal.entries_since(version_before)]})
        return rep

    # ------------------------------------------------------------------
    # Per-level pass
    # ------------------------------------------------------------------

    def _run_level(self, l: int, rep: MaintenanceReport) -> None:
        idx = self.index
        cfg = idx.config
        level = idx.levels[l]
        lam = self.lam
        pol = self.policy

        sizes = level.sizes().astype(np.float64)
        freqs = self.level_freqs(l).astype(np.float64)
        n_l = level.num_partitions
        if n_l <= 1:
            return

        # ---------------- Stage 1: estimate ----------------
        candidates: List[Tuple[float, str, int]] = []
        if pol.use_cost_model:
            d_over_p = self._parent_overhead(l, +1)
            d_over_m = self._parent_overhead(l, -1)
            for j in range(n_l):
                if sizes[j] >= 2:
                    est = (d_over_p - freqs[j] * lam(sizes[j])
                           + 2 * cfg.alpha * freqs[j] * lam(sizes[j] / 2))
                    if est < -cfg.tau_ns:
                        candidates.append((float(est), "split", j))
                if sizes[j] < cfg.min_partition_size and n_l > 2:
                    recv = self._nearest_partitions(l, j, 10)
                    est = cm.merge_delta_estimate(
                        lam, n_l, sizes[j], freqs[j], sizes[recv],
                        freqs[recv])
                    if est < -cfg.tau_ns:
                        candidates.append((float(est), "merge", j))
        else:
            # NoCost ablation: pure size thresholding (LIRE-style)
            mean_size = max(float(sizes.mean()), 1.0)
            for j in range(n_l):
                if sizes[j] > pol.split_size_threshold * mean_size \
                        and sizes[j] >= 2:
                    candidates.append((-np.inf, "split", j))
                elif sizes[j] < pol.merge_size_threshold * mean_size \
                        and n_l > 2:
                    candidates.append((-np.inf, "merge", j))

        candidates.sort(key=lambda t: t[0])
        touched: set = set()

        for est, kind, j in candidates:
            if j in touched or j >= level.num_partitions:
                continue
            if kind == "split":
                ok = self._try_split(l, j, float(freqs[j]), rep, touched)
                rep.splits += ok
                rep.rejected_splits += (not ok)
            else:
                ok = self._try_merge(l, j, float(freqs[j]), freqs, rep,
                                     touched)
                rep.merges += ok
                rep.rejected_merges += (not ok)

    # ------------------------------------------------------------------
    # Split
    # ------------------------------------------------------------------

    def _members(self, l: int, j: int) -> Tuple[np.ndarray, np.ndarray]:
        """(item vectors, item ids) of partition j at level l."""
        idx = self.index
        level = idx.levels[l]
        if level.vectors is not None:
            return level.vectors[j], level.ids[j]
        child = level.children[j]
        return idx.levels[l - 1].centroids[child], child

    def _try_split(self, l: int, j: int, freq: float,
                   rep: MaintenanceReport, touched: set) -> bool:
        idx = self.index
        cfg = idx.config
        level = idx.levels[l]
        x, ids = self._members(l, j)
        s = len(x)
        if s < 2:
            return False

        # ----- Stage 2: verify (virtual apply) -----
        c2, a2 = kmeans.split_two(x, seed=cfg.seed + j, device=idx.device)
        s_l, s_r = int((a2 == 0).sum()), int((a2 == 1).sum())
        if s_l == 0 or s_r == 0:
            return False
        d_over = self._parent_overhead_exact(l, j, +1)
        delta = (d_over - freq * float(self.lam(s))
                 + cfg.alpha * freq * float(self.lam(s_l) + self.lam(s_r)))
        gate = self.policy.use_rejection and self.policy.use_cost_model
        committed = (delta < -cfg.tau_ns) if gate else True
        rep.actions.append({"level": l, "part": j, "kind": "split",
                            "delta": delta, "committed": committed,
                            "sizes": (s, s_l, s_r)})
        if not committed:
            return False

        # ----- Stage 3: commit -----
        new_j = level.num_partitions
        self._apply_split(l, j, c2, a2)
        if self.faults is not None:
            self.faults.check("maintenance")   # crash mid-recluster
        touched.update({j, new_j})
        if self.policy.use_refinement:
            c0 = self.total_cost()
            self._refine_around(l, [j, new_j])
            rep.unpriced_cost += self.total_cost() - c0
        return True

    def _apply_split(self, l: int, j: int, c2: np.ndarray, a2: np.ndarray
                     ) -> None:
        idx = self.index
        # base-level splits change the partition directory itself:
        # structural for snapshot consumers.  Upper-level splits only touch
        # planning structures — bump the clock, dirty nothing.
        idx.journal.record(structural=(l == 0),
                           reason="split" if l == 0 else "split_upper")
        level = idx.levels[l]
        new_j = level.num_partitions
        level.centroids = np.concatenate([level.centroids, c2[1:2]])
        level.centroids[j] = c2[0]
        if level.vectors is not None:
            x, ids_, sq = level.vectors[j], level.ids[j], level.sqnorms[j]
            keep, move = a2 == 0, a2 == 1
            level.vectors[j] = np.ascontiguousarray(x[keep])
            level.ids[j] = ids_[keep]
            level.sqnorms[j] = sq[keep]
            level.vectors.append(np.ascontiguousarray(x[move]))
            level.ids.append(ids_[move])
            level.sqnorms.append(sq[move])
            for ext in level.ids[new_j]:
                idx.id_map[int(ext)] = new_j
        else:
            child = level.children[j]
            level.children[j] = child[a2 == 0]
            level.children.append(child[a2 == 1])
            below = idx.levels[l - 1]
            below.parent[level.children[new_j]] = new_j
        # stats: children inherit alpha * parent's window hits
        level.stats.ensure(level.num_partitions - 1)
        level.stats.split(j, idx.config.alpha)
        # parent bookkeeping: the new centroid joins j's parent partition
        if l < len(idx.levels) - 1:
            p = int(level.parent[j])
            level.parent = np.append(level.parent, p)
            up = idx.levels[l + 1]
            up.children[p] = np.append(up.children[p], new_j)
        idx._aug_extra = [None] * len(idx.levels)

    def _refine_around(self, l: int, seeds: List[int]) -> None:
        """Partition refinement (paper §4.2.1): one k-means round seeded by
        current centroids over the r_f nearest partitions to the split."""
        idx = self.index
        cfg = idx.config
        level = idx.levels[l]
        neigh = set()
        for j in seeds:
            neigh.update(self._nearest_partitions(
                l, j, cfg.refine_radius).tolist())
        neigh.update(seeds)
        group = np.asarray(sorted(neigh), dtype=np.int64)
        if len(group) < 2:
            return
        parts = [self._members(l, int(g)) for g in group]
        if sum(len(p[0]) for p in parts) == 0:
            return
        # contents + centroids of exactly ``group`` change: a delta-
        # refreshable content mutation at the base level
        idx.journal.record(dirty=group if l == 0 else None,
                           reason="refine" if l == 0 else "refine_upper")
        cents, new_parts = kmeans.refine(
            parts, level.centroids[group], iters=cfg.refine_iters,
            device=idx.device)
        level.centroids[group] = cents
        if level.vectors is not None:
            for g, (xg, ig) in zip(group, new_parts):
                g = int(g)
                level.vectors[g] = np.ascontiguousarray(xg)
                level.ids[g] = ig
                level.sqnorms[g] = np.sum(
                    xg.astype(np.float64) ** 2, axis=1).astype(np.float32)
                for ext in ig:
                    idx.id_map[int(ext)] = g
        else:
            below = idx.levels[l - 1]
            for g, (_, cg) in zip(group, new_parts):
                g = int(g)
                level.children[g] = cg.astype(np.int64)
                below.parent[level.children[g]] = g
        idx._aug_extra = [None] * len(idx.levels)

    # ------------------------------------------------------------------
    # Merge
    # ------------------------------------------------------------------

    def _nearest_partitions(self, l: int, j: int, r: int) -> np.ndarray:
        level = self.index.levels[l]
        c = level.centroids
        d = np.sum((c - c[j]) ** 2, axis=1)
        d[j] = np.inf
        r = min(r, level.num_partitions - 1)
        return np.argpartition(d, r - 1)[:r] if r >= 1 else \
            np.zeros(0, dtype=np.int64)

    def _try_merge(self, l: int, j: int, freq: float, freqs: np.ndarray,
                   rep: MaintenanceReport, touched: set) -> bool:
        idx = self.index
        cfg = idx.config
        level = idx.levels[l]
        n_l = level.num_partitions
        if n_l <= 2:
            return False
        x, ids = self._members(l, j)
        s = len(x)

        # ----- Stage 2: verify (virtual) -----
        if s > 0:
            mask = np.ones(n_l, dtype=bool)
            mask[j] = False
            others = np.where(mask)[0]
            sub = kmeans.assign(x, level.centroids[others],
                                device=idx.device)
            recv = others[sub]
        else:
            recv = np.zeros(0, dtype=np.int64)
        recv_ids, recv_counts = np.unique(recv, return_counts=True)
        if touched.intersection(recv_ids.tolist()):
            return False
        sizes = level.sizes().astype(np.float64)
        d_over = self._parent_overhead_exact(l, j, -1)
        extra_freq = freq * (recv_counts / max(s, 1))
        delta = cm.merge_delta_verify(
            self.lam, n_l, s, freq, sizes[recv_ids],
            sizes[recv_ids] + recv_counts, freqs[recv_ids], extra_freq)
        gate = self.policy.use_rejection and self.policy.use_cost_model
        committed = (delta < -cfg.tau_ns) if gate else True
        rep.actions.append({"level": l, "part": j, "kind": "merge",
                            "delta": delta, "committed": committed,
                            "size": s, "receivers": len(recv_ids)})
        if not committed:
            return False

        # ----- Stage 3: commit -----
        self._apply_merge(l, j, recv, extra_hits=extra_freq,
                          recv_ids=recv_ids)
        if self.faults is not None:
            self.faults.check("maintenance")   # crash mid-recluster
        touched.update(recv_ids.tolist())
        touched.add(j)
        return True

    def _apply_merge(self, l: int, j: int, recv: np.ndarray,
                     extra_hits: np.ndarray, recv_ids: np.ndarray) -> None:
        idx = self.index
        # merges swap-remove a partition: the directory shrinks and the
        # last partition changes id — structural at the base level
        idx.journal.record(structural=(l == 0),
                           reason="merge" if l == 0 else "merge_upper")
        level = idx.levels[l]
        x, ids = self._members(l, j)
        # 1) move members to receivers
        if level.vectors is not None:
            sq = level.sqnorms[j]
            for m in recv_ids:
                sel = recv == m
                level.vectors[m] = np.concatenate([level.vectors[m], x[sel]])
                level.ids[m] = np.concatenate([level.ids[m], ids[sel]])
                level.sqnorms[m] = np.concatenate([level.sqnorms[m], sq[sel]])
                for ext in ids[sel]:
                    idx.id_map[int(ext)] = int(m)
        else:
            below = idx.levels[l - 1]
            for m in recv_ids:
                sel = recv == m
                level.children[m] = np.concatenate(
                    [level.children[m], ids[sel]])
                below.parent[ids[sel]] = int(m)
        # receiver frequency bump for later estimates in this round
        level.stats.ensure(level.num_partitions)
        level.stats.boost(recv_ids, extra_hits)

        # 2) swap-remove partition j
        last = level.num_partitions - 1
        if l < len(idx.levels) - 1:
            up = idx.levels[l + 1]
            pj = int(level.parent[j])
            up.children[pj] = up.children[pj][up.children[pj] != j]
        if j != last:
            level.centroids[j] = level.centroids[last]
            if level.vectors is not None:
                level.vectors[j] = level.vectors[last]
                level.ids[j] = level.ids[last]
                level.sqnorms[j] = level.sqnorms[last]
                for ext in level.ids[j]:
                    idx.id_map[int(ext)] = j
            else:
                level.children[j] = level.children[last]
                idx.levels[l - 1].parent[level.children[j]] = j
            if l < len(idx.levels) - 1:
                p_last = int(level.parent[last])
                up = idx.levels[l + 1]
                up.children[p_last] = np.where(
                    up.children[p_last] == last, j, up.children[p_last])
                level.parent[j] = p_last
        level.centroids = level.centroids[:last]
        if level.vectors is not None:
            level.vectors.pop()
            level.ids.pop()
            level.sqnorms.pop()
        else:
            level.children.pop()
        if level.parent is not None:
            level.parent = level.parent[:last]
        level.stats.remove(j)
        idx._aug_extra = [None] * len(idx.levels)

    # ------------------------------------------------------------------
    # Level add / remove (paper §4.2.1)
    # ------------------------------------------------------------------

    def _maybe_adjust_levels(self, rep: MaintenanceReport) -> None:
        idx = self.index
        cfg = idx.config
        top = idx.levels[-1]
        if top.num_partitions > cfg.level_add_threshold:
            p_new = max(2, int(round(np.sqrt(top.num_partitions))))
            idx._add_level_from(p_new)
            rep.level_added = True
        elif (len(idx.levels) > 1
              and top.num_partitions < cfg.level_remove_threshold):
            idx.remove_top_level()
            rep.level_removed = True
