"""Device-resident batched multi-query executor (paper §7.4).

With a batch, every needed partition is scanned once per batch and the
read is shared by all queries that probe it:

  1. **Plan**: per-query probe sets, a fixed ``nprobe`` or APS-driven
     counts.  The vectorized planner is host numpy (centroid GEMM, the
     estimator on ``(B, n_consider)`` arrays, a radius calibrated from one
     batched sample search); the fused planner runs the centroid pass
     (the ``scan_topk`` kernel), the estimator and the probe selection on
     the device.  The per-query loop planner is the parity oracle.
  2. **Pack**: the probe sets become one frequency-ranked partition union
     plus a ``(B, U)`` mask, on the device (``ops.pack_round_masked``).
  3. **Scan**: ``ops.scan_selected_topk`` — the ``scan_topk_indexed``
     kernel reads each selected partition once per tile of queries; for
     int8 storage ``ops.scan_selected_topk_q8`` (the
     ``scan_topk_indexed_q8`` kernel) scans IVF-residual codes for the
     top-2k, re-ranked exactly from a host f32 mirror.
  4. **Rounds** (Algorithm 2): APS-planned searches run geometrically
     growing probe rounds (``run_round_loop``); each round scans the live
     queries' next probes (plus every not-yet-scanned probe that lands in
     the round's union), folds the result into a device-resident running
     top-k (``ops.topk_merge``), re-estimates recall from the running k-th
     distance and retires queries that cleared the target.

The executor serves a cached ``IndexSnapshot`` kept coherent through the
index's mutation journal: dirty-partition deltas patch only the touched
rows; structural changes or capacity overflow rebuild it.  Storage is
f32, bf16 or int8; an int8 snapshot is requantized by a full rebuild on
every journal delta.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from .. import sanitize
from ..kernels import ops
from ..kernels.ref import MASK_DIST
from . import aps as aps_mod
from .index import QuakeIndex
from .snapshot import IndexSnapshot

STORAGE_DTYPES = ("f32", "bf16", "int8")
U_BUCKET = 8        # union widths round up to a multiple of this


@dataclass
class BatchResult:
    ids: np.ndarray        # (B, k) external ids, -1 on misses
    dists: np.ndarray      # (B, k) minimization convention, inf on misses
    partitions_scanned: int = 0   # partition blocks streamed (union size,
                                  # summed over rounds)
    vectors_scanned: int = 0      # vectors streamed: each union partition
                                  # once per round it appears in
    comparisons: int = 0          # query-vector distance evaluations
    nprobe: Optional[np.ndarray] = None   # (B,) effective probes per query
    recall_estimate: Optional[np.ndarray] = None  # (B,) APS estimate (NaN
                                          # where no radius; None for
                                          # nprobe-pinned searches)
    rounds: int = 1                       # probe rounds executed
    round_trace: Optional[dict] = None    # per-round live queries /
                                          # vectors / partitions / ...


@dataclass
class BatchPlan:
    """Output of the batch planner."""
    sel: np.ndarray      # (U_pad,) union partition ids, frequency-ranked
                         # (tail entries duplicate sel[0], all-False masks)
    qmask: np.ndarray    # (B, U_pad) bool — query b probes union slot u
    nprobe: np.ndarray   # (B,) effective per-query probe count
    n_real: int          # distinct partitions actually scanned
    planned: Optional[np.ndarray] = None  # (B,) pre-cap planned counts
    anchor: Optional[np.ndarray] = None   # (B,) each query's nearest
    recall_est: Optional[np.ndarray] = None  # (B,) planner estimate
    sel_dev: Optional[torch.Tensor] = None   # device residents of sel and
    qmask_dev: Optional[torch.Tensor] = None  # qmask (what the scan reads)


@dataclass
class RoundPlan:
    """Per-query probe sequences plus the estimator state the round
    executor re-scores recall with.  Column 0 is each query's nearest
    partition; later columns descend by scan probability."""
    seq: np.ndarray         # (B, M) candidate partitions in scan order
    counts: np.ndarray      # (B,) planned probe counts
    geo: np.ndarray         # (B, M) seq-aligned geometry-space sq dists
    cc: np.ndarray          # (B, M) seq-aligned ||c_i - c_0|| distances
    recall_est: np.ndarray  # (B,) planner estimate at the planned cutoff
    seq_dev: Optional[torch.Tensor] = None  # device seq (fused planner)


# ---------------------------------------------------------------------------
# Centroid passes (host)
# ---------------------------------------------------------------------------

def _centroid_dists(index: QuakeIndex, q: np.ndarray,
                    cent_norms: Optional[np.ndarray] = None) -> np.ndarray:
    """(B, P) level-0 centroid distances in scan-order convention."""
    cents = index.levels[0].centroids
    if index.config.metric == "l2":
        if cent_norms is None:
            cent_norms = np.sum(cents * cents, axis=1)
        return (np.sum(q * q, 1)[:, None] + cent_norms[None, :]
                - 2.0 * (q @ cents.T))
    return -(q @ cents.T)


def _centroid_geo_batch(index: QuakeIndex, q: np.ndarray,
                        cent_norms: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """(B, P) geometry-space squared centroid distances (MIPS-augmented
    for IP)."""
    if index.config.metric == "l2":
        return np.maximum(_centroid_dists(index, q, cent_norms), 0.0)
    s = q @ index.levels[0].centroids.T
    return np.maximum(np.sum(q * q, 1)[:, None] + index._max_norm_sq
                      - 2.0 * s, 0.0)


# ---------------------------------------------------------------------------
# Radius calibration (host)
# ---------------------------------------------------------------------------

def _calib_sample(b: int) -> np.ndarray:
    return np.unique(np.linspace(0, b - 1, min(8, b)).astype(int))


def _calibrate_kth_loop(index: QuakeIndex, q: np.ndarray, k: int,
                        target: float) -> float:
    """One full host APS search per sample query (the loop planner's)."""
    kths = []
    for s in _calib_sample(q.shape[0]):
        r = index.search(q[s], k, recall_target=target, record_stats=False)
        if len(r.dists):
            kths.append(float(r.dists[min(k, len(r.dists)) - 1]))
    return float(np.median(kths)) if kths else np.inf


_CALIB_NPROBE = 8   # per-sample probes for radius calibration; an
                    # over-estimated radius only makes the planner scan more


def _calibrate_kth_batched(index: QuakeIndex, q: np.ndarray, k: int,
                           n_consider: int,
                           cache: Optional["PlannerCache"] = None) -> float:
    """One batched sample search: every sample row against the union of
    the samples' top-``_CALIB_NPROBE`` partitions in one host GEMM."""
    qs = q[_calib_sample(q.shape[0])]
    p = index.levels[0].num_partitions
    norms = None
    if cache is not None and cache._key == cache._fingerprint():
        norms = cache._cent_norms
    cd = _centroid_dists(index, qs, norms)
    n_cal = min(n_consider, _CALIB_NPROBE, p)
    if n_cal < p:
        probes = np.argpartition(cd, n_cal - 1, axis=1)[:, :n_cal]
        union = np.unique(probes)
    else:
        union = np.arange(p)
    lvl0 = index.levels[0]
    xs = [lvl0.vectors[j] for j in union]
    v = int(sum(len(x) for x in xs))
    if v == 0:
        return np.inf
    x = np.concatenate(xs)
    if index.config.metric == "l2":
        x2 = np.concatenate([lvl0.sqnorms[j] for j in union])
        d = (x2[None, :] - 2.0 * (qs @ x.T)
             + np.sum(qs * qs, 1)[:, None])
    else:
        d = -(qs @ x.T)
    kk = min(k, v)
    kth = np.partition(d, kk - 1, axis=1)[:, kk - 1]
    return float(np.median(kth.astype(np.float64)))


class PlannerCache:
    """Snapshot-fingerprinted planner state: cached centroid norms and
    calibrated APS radii, invalidated by the journal fingerprint; cached
    radii also expire after ``radius_ttl`` reuses (query drift); the TTL
    defaults to ``QuakeConfig.planner_radius_ttl``."""

    def __init__(self, index: QuakeIndex, radius_ttl: Optional[int] = None):
        self.index = index
        self.radius_ttl = index.config.planner_radius_ttl \
            if radius_ttl is None else radius_ttl
        self._key = None
        self._cent_norms = None
        self._kth_cache = {}     # (key, k, target) -> [kth_med, uses]
        self._dev = None         # fused-planner device residents

    def _fingerprint(self):
        return (self.index.version, self.index.num_partitions,
                self.index.num_vectors)

    def ensure_fresh(self):
        fp = self._fingerprint()
        if self._key != fp:
            cents = self.index.levels[0].centroids
            self._cent_norms = np.sum(cents * cents, axis=1)
            self._kth_cache = {}
            self._dev = None
            self._key = fp
        return self

    def device_arrays(self):
        """(centroids, MIPS augmentation extras, beta table) on the index's
        device for the fused planner, uploaded once per fingerprint."""
        if self._key != self._fingerprint() or self._dev is None:
            self.ensure_fresh()
            self._dev = _planner_tensors(self.index)
        return self._dev

    def get_radius(self, k: int, target: float) -> Optional[float]:
        if self._key != self._fingerprint():
            return None
        entry = self._kth_cache.get((self._key, k, float(target)))
        if entry is None or entry[1] >= self.radius_ttl:
            return None
        entry[1] += 1
        return entry[0]

    def put_radius(self, k: int, target: float, kth_med: float) -> None:
        if self._key == self._fingerprint():
            self._kth_cache[(self._key, k, float(target))] = [kth_med, 0]


def _planner_tensors(index: QuakeIndex):
    dev = index.device
    cents = torch.as_tensor(index.levels[0].centroids, device=dev)
    if index.config.metric == "ip":
        aug = torch.as_tensor(index._augment_extra(0), device=dev)
    else:
        aug = torch.zeros(cents.shape[0], dtype=torch.float64, device=dev)
    return cents, aug, torch.tensor(index._beta_table, device=dev)


# ---------------------------------------------------------------------------
# APS probe planning: per-query loop (parity oracle), vectorized, fused
# ---------------------------------------------------------------------------

def _aps_candidate_budget(index: QuakeIndex) -> int:
    cfg = index.config
    p = index.levels[0].num_partitions
    return min(max(int(np.ceil(cfg.f_m * p)), cfg.min_candidates), p)


def _aps_probe_counts_loop(index: QuakeIndex, q: np.ndarray, k: int,
                           target: float,
                           kth_med: Optional[float] = None,
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-query Python loop planner — the parity oracle for the
    vectorized planner.  Returns (sel (B, n_max), valid (B, n_max),
    counts (B,))."""
    b = q.shape[0]
    p = index.levels[0].num_partitions
    n_consider = _aps_candidate_budget(index)
    if kth_med is None:
        kth_med = _calibrate_kth_loop(index, q, k, target)

    sel = np.zeros((b, n_consider), dtype=np.int64)
    valid = np.zeros((b, n_consider), dtype=bool)
    counts = np.empty(b, dtype=np.int64)
    table = index._beta_table
    for i in range(b):
        qi = q[i]
        geo_i = index._centroid_geo_dists(qi, 0, np.arange(p))[0]
        order = np.argsort(geo_i, kind="stable")[:n_consider]
        rho_fn = index._rho_sq_from_item_dist(
            float(np.sum(qi.astype(np.float64) ** 2)))
        rho_sq = rho_fn(kth_med) if np.isfinite(kth_med) else np.inf
        if not np.isfinite(rho_sq) or rho_sq <= 0 or len(order) == 1:
            m = len(order)
            probes = order
        else:
            cc = index._centroid_cc_dists(0, order, 0)
            vmask = np.ones(len(order), dtype=bool)
            vmask[0] = False
            p0, probs = aps_mod.estimate_probs_np(
                float(geo_i[order[0]]), geo_i[order].astype(np.float64),
                cc, rho_sq, table, vmask)
            if p0 >= target:
                m, probes = 1, order[:1]
            else:
                desc = np.argsort(-probs, kind="stable")
                desc = desc[desc != 0]
                r_cum = p0 + np.cumsum(probs[desc])
                reach = np.nonzero(r_cum >= target)[0]
                extra = (reach[0] + 1) if len(reach) else len(desc)
                m = int(min(1 + extra, len(order)))
                probes = np.concatenate([order[:1], order[desc[:m - 1]]])
        sel[i, :m] = probes
        valid[i, :m] = True
        counts[i] = m
    n_max = int(counts.max())
    return sel[:, :n_max], valid[:, :n_max], counts


def _kth_for_plan(index, q, k, target, m, kth_med, cache):
    """The calibrated k-th distance: given, cached, or measured."""
    if kth_med is None:
        if cache is not None:
            kth_med = cache.get_radius(k, target)
        if kth_med is None:
            kth_med = _calibrate_kth_batched(index, q, k, m, cache=cache)
            if cache is not None:
                cache.put_radius(k, target, kth_med)
    return kth_med


def _aps_probe_counts_batched(index: QuakeIndex, q: np.ndarray, k: int,
                              target: float,
                              kth_med: Optional[float] = None,
                              cent_norms: Optional[np.ndarray] = None,
                              cache: Optional[PlannerCache] = None,
                              full: bool = False):
    """Vectorized APS planner on host arrays: the host centroid GEMM (its
    probe sets are bit-equal to the loop oracle's), the estimator on
    ``(B, n_consider)`` arrays and the probability cutoff.  Returns (sel,
    valid, counts, recall estimate) or, with ``full=True``, the
    :class:`RoundPlan`."""
    b = q.shape[0]
    cfg = index.config
    m = _aps_candidate_budget(index)
    kth_med = _kth_for_plan(index, q, k, target, m, kth_med, cache)

    cents = index.levels[0].centroids
    geo = _centroid_geo_batch(index, q, cent_norms)
    order = np.argsort(geo, axis=1, kind="stable")[:, :m]
    geo_sel = np.take_along_axis(geo, order, axis=1).astype(np.float64)

    q_norm = np.sum(q.astype(np.float64) ** 2, axis=1)
    if np.isfinite(kth_med):
        if cfg.metric == "l2":
            rho_sq = np.full(b, max(float(kth_med), 0.0))
        else:
            rho_sq = np.maximum(
                q_norm + index._max_norm_sq + 2.0 * float(kth_med), 0.0)
    else:
        rho_sq = np.full(b, np.inf)
    fallback = ~np.isfinite(rho_sq) | (rho_sq <= 0) | (m == 1)

    if m > 1:
        cg = cents[order].astype(np.float64)              # (B, M, d)
        d2 = np.sum((cg - cg[:, :1, :]) ** 2, axis=2)
        if cfg.metric == "ip":
            e = index._augment_extra(0)[order]
            d2 = d2 + (e - e[:, :1]) ** 2
        cc = np.sqrt(np.maximum(d2, 0.0))

        valid = np.ones((b, m), dtype=bool)
        valid[:, 0] = False
        p0, probs = aps_mod.estimate_probs_batch(
            geo_sel[:, 0], geo_sel, cc, rho_sq, index._beta_table, valid)

        # probability-descending order, nearest first (its +inf key
        # reproduces the loop's stable argsort-then-drop)
        neg = -probs
        neg[:, 0] = np.inf
        desc = np.argsort(neg, axis=1, kind="stable")[:, :m - 1]
        r_cum = p0[:, None] + np.cumsum(
            np.take_along_axis(probs, desc, axis=1), axis=1)
        reached = r_cum >= target
        extra = np.where(reached.any(axis=1),
                         np.argmax(reached, axis=1) + 1, m - 1)
        counts = np.where(p0 >= target, 1, np.minimum(1 + extra, m))
        seq = np.concatenate(
            [order[:, :1], np.take_along_axis(order, desc, axis=1)], axis=1)
        r_at = np.take_along_axis(
            r_cum, np.maximum(counts - 2, 0)[:, None], axis=1)[:, 0]
        r_est = np.where(counts <= 1, p0, r_at)
    else:
        counts = np.ones(b, dtype=np.int64)
        seq = order
        r_est = np.full(b, np.nan)
    counts = np.where(fallback, m, counts).astype(np.int64)
    seq = np.where(fallback[:, None], order, seq)
    r_est = np.where(fallback, np.nan, r_est)

    if full:
        if m > 1:
            def _seq_align(a):
                return np.where(
                    fallback[:, None], a,
                    np.concatenate(
                        [a[:, :1], np.take_along_axis(a, desc, axis=1)],
                        axis=1))
            geo_seq = _seq_align(geo_sel)
            cc_seq = _seq_align(cc)
        else:
            geo_seq = geo_sel
            cc_seq = np.zeros((b, 1))
        return RoundPlan(seq=seq.astype(np.int64), counts=counts,
                         geo=geo_seq.astype(np.float64),
                         cc=cc_seq.astype(np.float64), recall_est=r_est)

    n_max = int(counts.max())
    vmask = np.arange(n_max)[None, :] < counts[:, None]
    sel = np.where(vmask, seq[:, :n_max], 0).astype(np.int64)
    return sel, vmask, counts, r_est


def _fused_plan_probes(q, cents, aug_extra, max_norm_sq: float,
                       kth_med: float, table, target: float, *, m: int,
                       metric: str):
    """The APS batch planner on the device, with no host round trip:
    centroid pass (``ops.scan_topk``, the kernel on the card), beta-table
    lookup, recall estimation (``aps.estimate_probs_batch`` on tensors,
    in f64 as the host planner) and probe selection.

    Returns device tensors (seq (B, M) int64 scan-ordered candidates,
    counts (B,) int64, recall_est (B,) f64, geo_seq (B, M), cc_seq
    (B, M))."""
    b = q.shape[0]
    dev = q.device
    cd, order = ops.scan_topk(q, cents, m, metric=metric, impl="auto")
    order = order.long()
    cd = cd.double()
    if metric == "l2":
        geo_sel = torch.clamp(cd, min=0.0)
        rho_sq = torch.full((b,), max(kth_med, 0.0), dtype=torch.float64,
                            device=dev)
    else:
        q2 = torch.sum(q.double() ** 2, dim=1)
        geo_sel = torch.clamp(q2[:, None] + max_norm_sq + 2.0 * cd, min=0.0)
        rho_sq = torch.clamp(q2 + max_norm_sq + 2.0 * kth_med, min=0.0)
    if not math.isfinite(kth_med):
        rho_sq = torch.full_like(rho_sq, math.inf)
    if m == 1:
        return (order, torch.ones(b, dtype=torch.int64, device=dev),
                torch.full((b,), math.nan, dtype=torch.float64, device=dev),
                geo_sel, torch.zeros((b, 1), dtype=torch.float64,
                                     device=dev))
    fallback = ~torch.isfinite(rho_sq) | (rho_sq <= 0)

    cg = cents[order].double()                            # (B, M, d)
    d2 = torch.sum((cg - cg[:, :1, :]) ** 2, dim=2)
    if metric == "ip":
        e = aug_extra[order].double()
        d2 = d2 + (e - e[:, :1]) ** 2
    cc = torch.sqrt(torch.clamp(d2, min=0.0))

    valid = torch.ones((b, m), dtype=torch.bool, device=dev)
    valid[:, 0] = False
    p0, probs = aps_mod.estimate_probs_batch(
        geo_sel[:, 0], geo_sel, cc, rho_sq, table, valid)

    neg = -probs
    neg[:, 0] = math.inf
    desc = torch.argsort(neg, dim=1, stable=True)[:, :m - 1]
    r_cum = p0[:, None] + torch.cumsum(torch.gather(probs, 1, desc), dim=1)
    reached = r_cum >= target
    extra = torch.where(reached.any(dim=1),
                        torch.argmax(reached.to(torch.int8), dim=1) + 1,
                        m - 1)
    counts = torch.where(p0 >= target, 1, torch.clamp(1 + extra, max=m))
    counts = torch.where(fallback, m, counts).to(torch.int64)

    def _seq_align(a):
        tail = torch.gather(a, 1, desc)
        return torch.where(fallback[:, None], a,
                           torch.cat([a[:, :1], tail], dim=1))
    seq = _seq_align(order)
    geo_seq = _seq_align(geo_sel)
    cc_seq = _seq_align(cc)
    r_at = torch.gather(r_cum, 1, torch.clamp(counts - 2, min=0)[:, None])
    r_est = torch.where(counts <= 1, p0, r_at[:, 0])
    r_est = torch.where(fallback, math.nan, r_est)
    return seq, counts, r_est, geo_seq, cc_seq


def _aps_probe_counts_fused(index: QuakeIndex, q: np.ndarray, k: int,
                            target: float,
                            kth_med: Optional[float] = None,
                            cache: Optional[PlannerCache] = None,
                            full: bool = False):
    """Host wrapper of the fused device planner: calibration and cache
    lookups on the host (the numpy planner's policy), then one
    ``_fused_plan_probes`` call on the index's device.  Same return
    contracts as ``_aps_probe_counts_batched``."""
    m = _aps_candidate_budget(index)
    kth_med = _kth_for_plan(index, q, k, target, m, kth_med, cache)
    if cache is not None:
        cents_d, aug_d, table_d = cache.device_arrays()
    else:
        cents_d, aug_d, table_d = _planner_tensors(index)
    seq_d, counts_d, r_d, geo_d, cc_d = _fused_plan_probes(
        torch.as_tensor(q, device=index.device), cents_d, aug_d,
        float(index._max_norm_sq), float(kth_med), table_d, float(target),
        m=m, metric=index.config.metric)

    # the plan contract (round chunking, the host re-estimator) is
    # host-side: one pull per plan at this boundary
    # quakecheck: allow-sync(fused planner boundary: host plan contract)
    counts = counts_d.cpu().numpy()
    seq = seq_d.cpu().numpy()  # quakecheck: allow-sync(fused planner boundary)
    r_est = r_d.cpu().numpy()  # quakecheck: allow-sync(fused planner boundary)
    if full:
        return RoundPlan(seq=seq, counts=counts,
                         geo=geo_d.cpu().numpy(),  # quakecheck: allow-sync(fused planner boundary)
                         cc=cc_d.cpu().numpy(),    # quakecheck: allow-sync(fused planner boundary)
                         recall_est=r_est, seq_dev=seq_d)
    n_max = int(counts.max())
    vmask = np.arange(n_max)[None, :] < counts[:, None]
    sel = np.where(vmask, seq[:, :n_max], 0).astype(np.int64)
    return sel, vmask, counts, r_est


# ---------------------------------------------------------------------------
# Pack: probe sets -> partition union + per-query mask (device)
# ---------------------------------------------------------------------------

def _pack_plan(sel_q: torch.Tensor, qvalid: torch.Tensor,
               nearest: torch.Tensor, n_real: int, *, p: int, u_pad: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack per-query probe sets into a frequency-ranked union + mask on
    the device, with every query's nearest partition anchored above the
    ranking (a union cap never drops a query's best probe) and the inert
    tail past ``n_real``."""
    b = sel_q.shape[0]
    anchor = torch.zeros(p, dtype=torch.int32, device=sel_q.device)
    anchor[nearest] = 1
    return ops.pack_round_masked(sel_q, qvalid, anchor * (b + 1), n_real,
                                 p=p, u_pad=u_pad)


def plan_batch(index: QuakeIndex, q: np.ndarray, k: int,
               nprobe: Optional[int] = None,
               recall_target: Optional[float] = None,
               u_bucket: int = U_BUCKET,
               union_cap: Optional[int] = None,
               planner: str = "vectorized",
               cent_norms: Optional[np.ndarray] = None,
               cache: Optional[PlannerCache] = None) -> BatchPlan:
    """Plan one batched scan: per-query probe sets -> partition union +
    per-query mask.  ``planner`` is "vectorized" (host), "fused"
    (device) or "loop" (the per-query baseline); ``union_cap`` bounds the
    distinct partitions scanned (frequency-ranked truncation).  The union
    width is rounded up to a multiple of ``u_bucket`` with inert slots,
    as in the JAX package, so both give the same plan."""
    b = q.shape[0]
    p = index.levels[0].num_partitions
    dev = index.device

    if b == 0:
        return BatchPlan(sel=np.zeros(1, dtype=np.int64),
                         qmask=np.zeros((0, 1), dtype=bool),
                         nprobe=np.zeros(0, dtype=np.int64), n_real=0,
                         planned=np.zeros(0, dtype=np.int64))

    r_est = None
    if nprobe is not None:
        cd = _centroid_dists(index, q, cent_norms)
        n = int(max(1, min(nprobe, p)))
        if n < p:
            sel_q = np.argpartition(cd, n - 1, axis=1)[:, :n]
        else:
            sel_q = np.broadcast_to(np.arange(p), (b, p)).copy()
        qvalid = np.ones((b, n), dtype=bool)
        counts = np.full(b, n, dtype=np.int64)
        nearest = np.argmin(cd, axis=1)
    else:
        target = recall_target if recall_target is not None \
            else index.config.recall_target
        if planner == "loop":
            sel_q, qvalid, counts = _aps_probe_counts_loop(
                index, q, k, target)
        elif planner == "fused":
            sel_q, qvalid, counts, r_est = _aps_probe_counts_fused(
                index, q, k, target, cache=cache)
        else:
            sel_q, qvalid, counts, r_est = _aps_probe_counts_batched(
                index, q, k, target, cent_norms=cent_norms, cache=cache)
        nearest = sel_q[:, 0]

    hit = np.zeros(p, dtype=bool)
    hit[sel_q[qvalid]] = True
    n_hits = int(hit.sum())
    if union_cap:
        # floor the cap at the distinct-anchor count, so no query loses
        # its whole probe set to the cap
        n_anchor = int(len(np.unique(nearest)))
        n_real = min(n_hits, max(union_cap, n_anchor))
    else:
        n_real = n_hits
    n_real = max(n_real, 1)
    u_pad = max(-(-n_real // u_bucket) * u_bucket, 1)
    sel_d, qmask_d = _pack_plan(
        torch.as_tensor(sel_q, device=dev),
        torch.as_tensor(qvalid, device=dev),
        torch.as_tensor(nearest, device=dev), n_real, p=p, u_pad=u_pad)
    # introspection reads the plan on the host: one pull at the boundary
    # quakecheck: allow-sync(host plan mirror for introspection)
    sel = sel_d.long().cpu().numpy()
    qmask = qmask_d.cpu().numpy()  # quakecheck: allow-sync(host plan mirror)
    eff = qmask[:, :n_real].sum(axis=1).astype(np.int64)
    if r_est is not None:
        # a cap that truncated a query's probes invalidates its estimate
        r_est = np.where(eff < counts, np.nan, r_est)
    return BatchPlan(sel=sel, qmask=qmask, nprobe=eff, n_real=n_real,
                     planned=counts,
                     anchor=np.asarray(nearest, dtype=np.int64),
                     recall_est=r_est, sel_dev=sel_d, qmask_dev=qmask_d)


# ---------------------------------------------------------------------------
# Multi-round early-exit execution (Algorithm 2)
# ---------------------------------------------------------------------------

def plan_rounds(index: QuakeIndex, q: np.ndarray, k: int, target: float,
                planner: str = "vectorized",
                cache: Optional[PlannerCache] = None,
                cent_norms: Optional[np.ndarray] = None) -> RoundPlan:
    """APS probe planning for the round executor: scan-ordered candidate
    sequences plus seq-aligned estimator inputs.  ``planner`` is
    "vectorized" (host) or "fused" (device)."""
    if planner == "fused":
        return _aps_probe_counts_fused(index, q, k, target, cache=cache,
                                       full=True)
    return _aps_probe_counts_batched(index, q, k, target,
                                     cent_norms=cent_norms, cache=cache,
                                     full=True)


def _round_windows(n_max: int, rounds: Optional[int] = None):
    """Column windows chunking a probe list of length ``n_max`` into
    geometrically growing rounds: single-probe windows for probes 1..3,
    then doubling.  A ``rounds`` budget merges the tail into the last
    round (``rounds=1`` is one fixed-plan scan)."""
    wins, c0, w = [], 0, 1
    while c0 < n_max:
        wins.append((c0, min(c0 + w, n_max)))
        c0 += w
        if len(wins) >= 3:
            w *= 2
    if rounds is not None and rounds >= 1 and len(wins) > rounds:
        wins = wins[:rounds - 1] + [(wins[rounds - 1][0], n_max)]
    return wins


def run_round_loop(plan: RoundPlan, k: int, target: float, table,
                   rho_fn, scan_round, *, rounds: Optional[int] = None,
                   k_keep: Optional[int] = None, device="cpu",
                   deadline_s: Optional[float] = None, clock=None):
    """Algorithm 2 round driver.

    Each round every live query advances through the next window of its
    probe sequence; the window's partitions form the round's union, and
    every live query also consumes its not-yet-scanned probes that land
    in that union (a partition streams at most once per batch).
    ``scan_round(take, kept)`` packs and scans the round and returns
    device ``(dists (B, k_keep), ids (B, k_keep), stats)``.  The driver
    keeps the running top-k on ``device`` (``ops.topk_merge``), pulls only
    the k-th distances each round, re-estimates APS recall of the live
    rows from the running radius and retires rows that cleared the
    target; rows whose top-k is not full never exit.

    ``deadline_s`` is a budget for the whole loop, read on ``clock``
    (default ``time.perf_counter``): once it is spent the loop stops at
    the end of the current round (at least one round always runs) and
    the live rows keep their running top-k; ``trace["budget_expired"]``
    and ``trace["timed_out_rows"]`` say that it happened.

    Returns (top dists, top ids — device, ascending — nprobe (B,),
    recall_est (B,), rounds executed, per-round trace, totals).
    """
    b, m = plan.seq.shape
    counts = plan.counts
    k_keep = k if k_keep is None else k_keep
    n_max = int(counts.max(initial=1))
    wins = _round_windows(n_max, rounds)
    td = torch.full((b, k_keep), MASK_DIST, dtype=torch.float32,
                    device=device)
    ti = torch.full((b, k_keep), -1, dtype=torch.int32, device=device)
    live = np.ones(b, dtype=bool)
    r_est = np.asarray(plan.recall_est, dtype=np.float64).copy()
    scanned = np.zeros((b, m), dtype=bool)
    valid = np.ones((b, m), dtype=bool)
    valid[:, 0] = False
    cols = np.arange(m)[None, :]
    within = cols < counts[:, None]
    p_hi = int(plan.seq.max()) + 1
    # the pinned per-round trace schema: parallel per-round lists plus
    # two scalar outcome flags
    trace = {"round_live": [], "round_partitions": [],
             "round_vectors": [], "round_comparisons": [],
             "round_kth": [], "round_wall_s": [],
             "budget_expired": False, "timed_out_rows": 0}
    clock = clock or time.perf_counter
    t0 = clock()
    n_rounds = 0
    for c0, c1 in wins:
        if not live.any():
            break
        if (deadline_s is not None and n_rounds > 0
                and clock() - t0 >= deadline_s):
            # budget spent: the live rows keep their running top-k
            trace["budget_expired"] = True
            trace["timed_out_rows"] = int(live.sum())
            break
        avail = live[:, None] & within & ~scanned
        base = avail & (cols >= c0) & (cols < c1)
        if not base.any():
            continue          # window already consumed by riding
        kept = np.unique(plan.seq[base])
        in_union = np.zeros(p_hi, dtype=bool)
        in_union[kept] = True
        take = avail & in_union[plan.seq]
        scanned |= take
        n_rounds += 1
        t_round = clock()
        trace["round_live"].append(int(live.sum()))
        d, i, st = scan_round(take, kept)
        td, ti = ops.topk_merge(td, ti, d, i, k_keep)
        for key in ("partitions", "vectors", "comparisons"):
            trace[f"round_{key}"].append(int(st[key]))
        rows = np.nonzero(live)[0]
        # quakecheck: allow-sync(Algorithm 2's per-round kth-distance pull: the early-exit recall re-estimate is host-side by design)
        kth = td[:, k - 1].double().cpu().numpy()[rows]
        full_heap = kth < MASK_DIST
        rho_sq = np.where(full_heap, rho_fn(kth, rows), np.inf)
        p0, probs = aps_mod.estimate_probs_batch(
            plan.geo[rows, 0], plan.geo[rows], plan.cc[rows], rho_sq,
            table, valid[rows])
        r = p0 + np.where(scanned[rows] & valid[rows], probs,
                          0.0).sum(axis=1)
        r_est[rows[full_heap]] = r[full_heap]
        live[rows[full_heap & (r >= target)]] = False
        trace["round_kth"].append(
            float(np.median(kth[full_heap])) if full_heap.any() else None)
        trace["round_wall_s"].append(clock() - t_round)
    stats = {k_: int(np.sum(v)) for k_, v in
             (("partitions", trace["round_partitions"]),
              ("vectors", trace["round_vectors"]),
              ("comparisons", trace["round_comparisons"]))}
    return (td, ti, scanned.sum(axis=1).astype(np.int64), r_est,
            n_rounds, trace, stats)


def _batch_rho_fn(index: QuakeIndex, q: np.ndarray):
    """Vectorized kth-item-distance -> squared-radius map for the round
    loop; the callable takes (kth, rows) with ``rows`` the live subset."""
    if index.config.metric == "l2":
        return lambda kth, rows=None: aps_mod.rho_sq_batch(kth,
                                                           metric="l2")
    qn = np.sum(q.astype(np.float64) ** 2, axis=1)
    m2 = index._max_norm_sq
    return lambda kth, rows=None: aps_mod.rho_sq_batch(
        kth, metric="ip", q_norm_sq=qn if rows is None else qn[rows],
        max_norm_sq=m2)


class BatchedSearchExecutor:
    """Executes planned batches against a snapshot on the index's device.

    The snapshot is cached and kept coherent with the dynamic index
    through its mutation journal: content changes confined to known
    partitions patch only those rows (``IndexSnapshot.apply_delta`` in
    place); structural changes, capacity overflow, or more than
    ``config.snapshot_max_dirty_frac * P`` dirty partitions rebuild it
    with ``config.snapshot_headroom`` slack capacity.

    ``storage_dtype`` is "f32" (exact), "bf16" (half the scan bytes;
    products accumulate in f32) or "int8" (IVF-residual SQ8 codes, a
    quarter of the bytes; any journal delta requantizes by a full
    rebuild).  With ``int8_rerank`` the int8 scan keeps the top-2k and
    re-ranks them exactly from a compact host f32 mirror of the level-0
    rows.

    ``impl`` is the scan implementation every search uses unless it names
    its own, ``u_bucket`` the union-width padding step, ``rounds`` the
    default round budget of APS searches (1 = one fixed-plan scan),
    ``union_cap`` the default union cap, ``headroom`` overrides the
    config's slot slack, and
    ``part_bucket`` pads the snapshot's partition count (sticky, with 25%
    growth slack) so a few maintenance splits keep the scan operands'
    shape; serving runtimes set 32.
    """

    def __init__(self, index: QuakeIndex, impl: str = "auto",
                 u_bucket: int = U_BUCKET, headroom: Optional[float] = None,
                 storage_dtype: str = "f32",
                 union_cap: Optional[int] = None,
                 planner: str = "vectorized", int8_rerank: bool = True,
                 rounds: Optional[int] = None, part_bucket: int = 1):
        if storage_dtype not in STORAGE_DTYPES:
            raise ValueError(f"storage_dtype must be one of "
                             f"{STORAGE_DTYPES}, got {storage_dtype!r}")
        if planner not in ("vectorized", "fused", "loop"):
            raise ValueError(f"unknown planner {planner!r}")
        self.index = index
        self.impl = impl
        self.u_bucket = u_bucket
        self.part_bucket = max(part_bucket, 1)
        self.storage_dtype = storage_dtype
        self.planner = planner
        self.rounds = rounds
        self.int8_rerank = int8_rerank
        cfg = index.config
        self.union_cap = cfg.union_cap if union_cap is None else union_cap
        self.headroom = cfg.snapshot_headroom if headroom is None \
            else headroom
        self._mirror = None      # int8 re-rank: level-0 rows (N, d) host
        self._mirror_base = None  # (P,) first mirror row of each partition
        self._snap = None
        self._key = None         # fingerprint the snapshot reflects
        self._valid = None       # (P, S_cap) bool, device
        self._flat_ids = None    # (P*S_cap,) host
        self._sizes = None       # (P,) host
        self.planner_cache = PlannerCache(index)
        self.full_rebuilds = 0   # refresh telemetry
        self.delta_refreshes = 0

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _fingerprint(self):
        return (self.index.version, self.index.num_partitions,
                self.index.num_vectors)

    @property
    def _cent_norms(self):
        return self.planner_cache._cent_norms

    def refresh(self):
        """Full rebuild of the device snapshot.  The slot capacity is
        sticky: a rebuild never shrinks it below the previous one's."""
        lvl0 = self.index.levels[0]
        max_sz = int(max((len(v) for v in lvl0.vectors), default=0))
        cap = max(int(math.ceil(max_sz * max(self.headroom, 1.0))), 1)
        if self._snap is not None:
            cap = max(cap, int(self._snap.capacity))
        pad_to = self.part_bucket
        if self.part_bucket > 1:
            # sticky too, with 25% growth slack; an absolute target that
            # covers the live count (from_index rounds up to a multiple)
            pad_to = (-(-int(lvl0.num_partitions * 1.25)
                        // self.part_bucket) * self.part_bucket)
            if self._snap is not None:
                pad_to = max(pad_to, int(self._snap.num_partitions))
            pad_to = max(pad_to, lvl0.num_partitions)
        self._snap = None        # drop the old tensors before the new ones
        snap = IndexSnapshot.from_index(
            self.index, capacity=cap, int8=self.storage_dtype == "int8",
            pad_partitions_to=pad_to)
        self._valid = snap.ids >= 0
        self._flat_ids = snap.ids.cpu().numpy().reshape(-1)
        self._sizes = snap.sizes.cpu().numpy()
        if self.storage_dtype == "bf16":
            snap = replace(snap, data=snap.data.to(torch.bfloat16))
        elif self.storage_dtype == "int8":
            if self.int8_rerank:
                sizes = lvl0.sizes().astype(np.int64)
                self._mirror = np.concatenate(
                    [np.asarray(v, dtype=np.float32) for v in lvl0.vectors]
                    + [np.zeros((0, self.index.dim), np.float32)])
                self._mirror_base = np.concatenate(
                    [[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        self._snap = snap
        self.planner_cache.ensure_fresh()
        self._key = self._fingerprint()
        self.full_rebuilds += 1
        return self._snap

    def _refresh_delta(self, delta) -> bool:
        """Patch the dirty partition rows instead of a rebuild.  False when
        the delta does not apply (structural change, capacity overflow,
        dirty set too large); the caller then rebuilds."""
        if self._snap.scales is not None:
            return False          # int8: requantize by a full rebuild
        idx = self.index
        lvl0 = idx.levels[0]
        p_real = lvl0.num_partitions
        if delta.structural or p_real > self._snap.num_partitions:
            return False
        dirty = sorted(j for j in delta.dirty if j < p_real)
        max_dirty = idx.config.snapshot_max_dirty_frac * max(p_real, 1)
        if len(dirty) > max_dirty:
            return False
        if not dirty:
            self._key = self._fingerprint()
            return True
        cap = self._snap.capacity
        if max(len(lvl0.vectors[j]) for j in dirty) > cap:
            return False      # a partition outgrew its slack slots
        try:
            patch = IndexSnapshot.build_patch(idx, dirty, cap)
        except ValueError:
            return False
        # the executor owns its snapshot exclusively: patch in place
        self._snap = self._snap.apply_delta(patch, donate=True)
        rows = torch.as_tensor(patch.rows.astype(np.int64),
                               device=self.device)
        self._valid.index_copy_(
            0, rows, torch.as_tensor(patch.ids >= 0, device=self.device))
        self._flat_ids.reshape(self._snap.num_partitions, cap)[
            patch.rows] = patch.ids
        self._sizes[patch.rows] = patch.sizes
        self.planner_cache.ensure_fresh()   # refine deltas move centroids
        self._key = self._fingerprint()
        self.delta_refreshes += 1
        return True

    def release(self) -> None:
        """Free the device snapshot and its mask; the next search
        rebuilds them from the index."""
        self._snap = None
        self._valid = None
        self._key = None

    def snapshot(self):
        if self._snap is None:
            return self.refresh()
        if self._key == self._fingerprint():
            return self._snap
        delta = self.index.journal.delta_since(self._key[0])
        if delta is None or not self._refresh_delta(delta):
            self.refresh()
        return self._snap

    def _rerank_exact(self, q: np.ndarray, flat: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact f32 re-rank of the int8 scan's candidates ``flat`` (B, 2k)
        from the host mirror: float64 distances and a stable argsort, as
        in the JAX package.  Returns (dists (B, k), flat idx (B, k)),
        ``inf`` / -1 on misses."""
        b, k2 = flat.shape
        cap = self._snap.capacity
        f = np.maximum(flat, 0)
        rows = np.where(flat >= 0, self._mirror_base[f // cap] + f % cap, 0)
        if self._mirror.shape[0] == 0:
            x = np.zeros((b, k2, q.shape[1]), dtype=np.float32)
        else:
            x = self._mirror[rows.reshape(-1)].reshape(b, k2, -1)
        if self.index.config.metric == "l2":
            diff = x - q[:, None, :]
            de = np.einsum("bkd,bkd->bk", diff, diff, dtype=np.float64)
        else:
            de = -np.einsum("bkd,bd->bk", x, q, dtype=np.float64)
        de = np.where(flat >= 0, de, np.inf)
        order = np.argsort(de, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(de, order, axis=1),
                np.take_along_axis(flat, order, axis=1))

    def _to_result_ids(self, flat: np.ndarray) -> np.ndarray:
        return np.where(flat >= 0, self._flat_ids[np.maximum(flat, 0)],
                        -1).astype(np.int64)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None,
               recall_target: Optional[float] = None,
               impl: Optional[str] = None,
               union_cap: Optional[int] = None,
               rounds: Optional[int] = None) -> BatchResult:
        """One batch: APS probe rounds (Algorithm 2) unless ``nprobe`` pins
        the probes, ``rounds=1`` asks for one fixed-plan scan, the loop
        planner is used, or a union cap (default the executor's) bounds
        the plan.  ``impl``, ``rounds`` and ``union_cap`` default to the
        executor's."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[0] == 0:
            return BatchResult(ids=np.zeros((0, k), dtype=np.int64),
                               dists=np.zeros((0, k), dtype=np.float64),
                               nprobe=np.zeros(0, dtype=np.int64),
                               recall_estimate=np.zeros(0))
        snap = self.snapshot()
        impl = impl or self.impl
        rounds = self.rounds if rounds is None else rounds
        if rounds is not None and rounds < 1:
            raise ValueError(f"rounds must be >= 1 or None, got {rounds}")
        cap = self.union_cap if union_cap is None else union_cap
        # early-exit rounds need APS: not nprobe-pinned, not rounds=1,
        # not the loop planner, not union-capped (the cap is plan-level)
        if nprobe is None and rounds != 1 and self.planner != "loop" \
                and not cap:
            target = recall_target if recall_target is not None \
                else self.index.config.recall_target
            return self._search_rounds(q, k, target, rounds, impl=impl,
                                       snap=snap)
        plan = plan_batch(self.index, q, k, nprobe=nprobe,
                          recall_target=recall_target,
                          u_bucket=self.u_bucket, union_cap=cap,
                          planner=self.planner,
                          cent_norms=self._cent_norms,
                          cache=self.planner_cache)
        dev = self.device
        sel_dev = plan.sel_dev if plan.sel_dev is not None \
            else torch.as_tensor(plan.sel, device=dev)
        qmask_dev = plan.qmask_dev if plan.qmask_dev is not None \
            else torch.as_tensor(plan.qmask, device=dev)
        q_dev = torch.as_tensor(q, device=dev)
        metric = self.index.config.metric
        rerank = snap.scales is not None and self._mirror is not None
        if snap.scales is not None:          # int8 residual codes
            dd, flat = ops.scan_selected_topk_q8(
                q_dev, snap.data, snap.scales, self._valid, sel_dev,
                qmask_dev, 2 * k if rerank else k, metric=metric,
                centroids=snap.centroids, impl=impl)
        else:
            dd, flat = ops.scan_selected_topk(
                q_dev, snap.data, self._valid, sel_dev, qmask_dev, k,
                metric=metric, impl=impl)
        if rerank:
            # quakecheck: allow-sync(int8 rerank gathers from the host f32 mirror)
            dd, flat = self._rerank_exact(q, flat.cpu().numpy(), k)
        else:
            # quakecheck: allow-sync(result boundary: BatchResult is a host contract)
            dd = dd.double().cpu().numpy()
            flat = flat.cpu().numpy()  # quakecheck: allow-sync(result boundary)
        dd = np.where(dd >= MASK_DIST, np.inf, dd)
        sizes_sel = self._sizes[plan.sel[:plan.n_real]]
        return BatchResult(
            ids=self._to_result_ids(flat), dists=dd,
            partitions_scanned=int(plan.n_real),
            vectors_scanned=int(sizes_sel.sum()),
            comparisons=int((plan.qmask[:, :plan.n_real].astype(np.int64)
                             * sizes_sel[None, :]).sum()),
            nprobe=plan.nprobe, recall_estimate=plan.recall_est)

    def scan_probe_round(self, q_dev, seq_dev, take: np.ndarray,
                         kept: np.ndarray, k_keep: int, snap=None,
                         impl: Optional[str] = None, u_pow2: bool = False,
                         seq_host: Optional[np.ndarray] = None):
        """One packed partition-union scan for a probe round over any row
        set: ``q_dev`` (B, d) queries, ``seq_dev`` (B, M) scan-ordered
        candidates on the device, ``take`` (B, M) the cells consumed this
        round, ``kept`` the round's distinct partitions.  Returns device
        ``(dists (B, k_keep), flat idx, stats)`` (``run_round_loop``'s
        contract).  It serves both round drivers: ``_search_rounds`` and
        the serving scheduler's riding rounds, whose row set changes
        between rounds.  ``u_pow2`` pads the union on a geometric ladder
        (``u_bucket * 2^i``) instead of linear ``u_bucket`` steps.  With
        ``seq_host`` the comparison count is exact."""
        snap = self.snapshot() if snap is None else snap
        # the snapshot's (padded) partition count: stable across rebuilds
        # when part_bucket > 1
        p = max(self.index.levels[0].num_partitions,
                int(snap.num_partitions))
        prio0 = torch.zeros(p, dtype=torch.int32, device=self.device)
        n_real = max(len(kept), 1)
        u_pad = max(-(-n_real // self.u_bucket) * self.u_bucket, 1)
        if u_pow2:
            u_pad = self.u_bucket * ops._next_pow2(
                -(-n_real // self.u_bucket))
        with sanitize.allow_sync("explicit upload of the round's take mask"):
            take_dev = torch.as_tensor(take, device=self.device)
        sel_dev, qmask_dev = ops.pack_round_masked(
            seq_dev, take_dev, prio0, n_real, p=p, u_pad=u_pad)
        sizes_kept = self._sizes[np.asarray(kept, dtype=np.int64)]
        vectors = int(sizes_kept.sum())
        if seq_host is not None:
            comparisons = int(self._sizes[seq_host[take]].sum())
        else:
            comparisons = vectors
        st = {"partitions": int(n_real), "vectors": vectors,
              "comparisons": comparisons}
        impl = impl or self.impl
        if snap.scales is not None:          # int8 residual codes
            d, flat = ops.scan_selected_topk_q8(
                q_dev, snap.data, snap.scales, self._valid, sel_dev,
                qmask_dev, k_keep, metric=self.index.config.metric,
                centroids=snap.centroids, impl=impl)
        else:
            d, flat = ops.scan_selected_topk(
                q_dev, snap.data, self._valid, sel_dev, qmask_dev, k_keep,
                metric=self.index.config.metric, impl=impl)
        return d, flat, st

    def _search_rounds(self, q: np.ndarray, k: int, target: float,
                       rounds: Optional[int], impl: Optional[str] = None,
                       snap=None) -> BatchResult:
        """Multi-round early-exit search (Algorithm 2 semantics)."""
        idx = self.index
        snap = self.snapshot() if snap is None else snap
        rplan = plan_rounds(idx, q, k, target, planner=self.planner,
                            cache=self.planner_cache,
                            cent_norms=self._cent_norms)
        q_dev = torch.as_tensor(q, device=self.device)
        seq_dev = rplan.seq_dev if rplan.seq_dev is not None \
            else torch.as_tensor(rplan.seq, device=self.device)
        rerank = snap.scales is not None and self._mirror is not None
        k_keep = 2 * k if rerank else k

        def scan_round(take, kept):
            return self.scan_probe_round(q_dev, seq_dev, take, kept, k_keep,
                                         snap=snap, impl=impl,
                                         seq_host=rplan.seq)

        td, ti, nprobe, r_est, n_rounds, trace, stats = run_round_loop(
            rplan, k, target, idx._beta_table, _batch_rho_fn(idx, q),
            scan_round, rounds=rounds, k_keep=k_keep, device=self.device)
        if rerank:
            # quakecheck: allow-sync(int8 rerank gathers from the host f32 mirror)
            dd, flat = self._rerank_exact(q, ti.cpu().numpy(), k)
        else:
            # quakecheck: allow-sync(result boundary: BatchResult is a host contract)
            dd = td.double().cpu().numpy()[:, :k]
            flat = ti.cpu().numpy()[:, :k]  # quakecheck: allow-sync(result boundary)
        dd = np.where(dd >= MASK_DIST, np.inf, dd)
        return BatchResult(
            ids=self._to_result_ids(flat), dists=dd,
            partitions_scanned=stats["partitions"],
            vectors_scanned=stats["vectors"],
            comparisons=stats["comparisons"],
            nprobe=nprobe, recall_estimate=r_est,
            rounds=n_rounds, round_trace=trace)


def get_executor(index: QuakeIndex,
                 storage_dtype: Optional[str] = None
                 ) -> BatchedSearchExecutor:
    """The index's cached executor for ``storage_dtype`` (one executor and
    one device snapshot per storage format; None means f32)."""
    key = storage_dtype or "f32"
    cache = getattr(index, "_batch_executors", None)
    if cache is None:
        cache = index._batch_executors = {}
    ex = cache.get(key)
    if ex is None or ex.index is not index:
        ex = BatchedSearchExecutor(index, storage_dtype=key)
        cache[key] = ex
    return ex


def batch_search(index: QuakeIndex, queries: np.ndarray, k: int,
                 nprobe: Optional[int] = None,
                 recall_target: Optional[float] = None,
                 impl: str = "auto",
                 union_cap: Optional[int] = None,
                 storage_dtype: Optional[str] = None,
                 rounds: Optional[int] = None) -> BatchResult:
    """Scan-each-partition-once batched search over the dynamic index:
    fixed ``nprobe`` or APS-planned probe rounds (``rounds=1`` forces one
    fixed-plan scan), on the index's device."""
    return get_executor(index, storage_dtype).search(
        queries, k, nprobe=nprobe, recall_target=recall_target, impl=impl,
        union_cap=union_cap, rounds=rounds)


def per_query_search(index: QuakeIndex, queries: np.ndarray, k: int,
                     nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None,
                     impl: str = "auto") -> BatchResult:
    """Baseline: one query at a time through the same executor, so
    partitions are re-scanned per query."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    if q.shape[0] == 0:
        return BatchResult(ids=np.zeros((0, k), dtype=np.int64),
                           dists=np.zeros((0, k), dtype=np.float64),
                           nprobe=np.zeros(0, dtype=np.int64))
    ex = get_executor(index)
    ids, dists, parts, vecs, comps = [], [], 0, 0, 0
    nps, rests, max_rounds = [], [], 1
    for row in q:
        r = ex.search(row[None, :], k, nprobe=nprobe,
                      recall_target=recall_target, impl=impl)
        ids.append(r.ids[0])
        dists.append(r.dists[0])
        parts += r.partitions_scanned
        vecs += r.vectors_scanned
        comps += r.comparisons
        nps.append(int(r.nprobe[0]) if r.nprobe is not None else 0)
        rests.append(float(r.recall_estimate[0])
                     if r.recall_estimate is not None else np.nan)
        max_rounds = max(max_rounds, r.rounds)
    rest = np.asarray(rests)
    return BatchResult(ids=np.stack(ids), dists=np.stack(dists),
                       partitions_scanned=parts, vectors_scanned=vecs,
                       comparisons=comps, nprobe=np.asarray(nps),
                       recall_estimate=None if np.isnan(rest).all()
                       else rest, rounds=max_rounds)
