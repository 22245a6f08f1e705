"""Adaptive Partition Scanning (paper §5, Algorithm 1).

APS decides, per query, how many partitions to scan to hit a recall
target: scan the nearest partition to set the radius ``rho`` (distance to
the current k-th neighbour), estimate each unscanned candidate's
probability of holding a true neighbour from hyperspherical-cap volumes
(geometry.py), and scan candidates in descending probability until the
accumulated estimate clears the target, recomputing probabilities only
when ``rho`` shrank by more than ``tau_rho`` (paper opt. #2).

  * ``aps_scan`` — the host-driven sequential loop of the dynamic index
    (numpy; partition contents are ragged).
  * ``estimate_probs_batch`` — the estimator on ``(B, M)`` arrays, for
    host numpy arrays (the vectorized planner and the round driver) and
    for torch tensors (the fused device planner).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import numpy as np
import torch

from . import geometry

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Estimator math
# ---------------------------------------------------------------------------

def estimate_probs(d0_sq: Tensor, di_sq: Tensor, cc_dist: Tensor,
                   rho_sq: Tensor, table: Tensor, valid: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """p0 and per-candidate probabilities (Eqs. 7-9) for one query, on
    tensors: d0_sq ||q-c0||^2, di_sq (M,), cc_dist (M,) ||ci-c0||,
    rho_sq the radius^2, valid (M,) with the nearest excluded."""
    rho = torch.sqrt(torch.clamp(rho_sq, min=1e-30))
    h = geometry.bisector_margins(d0_sq, di_sq, cc_dist)
    v = geometry.cap_fraction(h / rho, table)
    v = torch.where(valid, v, torch.zeros_like(v))
    return geometry.partition_probabilities(v, valid)


def estimate_probs_np(d0_sq: float, di_sq: np.ndarray, cc_dist: np.ndarray,
                      rho_sq: float, table, valid: np.ndarray
                      ) -> Tuple[float, np.ndarray]:
    """Numpy estimator for the host scan loop.  ``table`` is the beta grid
    or a callable ``beta_fn(x) -> I_x(a, 1/2)`` (the APS-RP ablation)."""
    rho = np.sqrt(max(rho_sq, 1e-30))
    h = (di_sq - d0_sq) / (2.0 * np.maximum(cc_dist, 1e-20))
    t = np.clip(h / rho, -1.0, 1.0)
    x = np.clip(1.0 - t * t, 0.0, 1.0)
    if callable(table):
        half = 0.5 * np.asarray(table(x), dtype=np.float64)
    else:
        n = len(table)
        pos = x * (n - 1)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 2)
        frac = pos - lo
        half = 0.5 * (table[lo] * (1.0 - frac) + table[lo + 1] * frac)
    v = np.where(t >= 0, half, 1.0 - half)
    v = np.where(valid, v, 0.0)
    total = float(v.sum())
    if total <= 0:
        return 1.0, np.zeros_like(v)
    vn = v / total
    p0 = float(np.exp(np.sum(np.log1p(-np.clip(vn[valid], 0.0, 1 - 1e-7)))))
    p = (1.0 - p0) * vn
    return p0, p


def _pairwise_sum(x: Tensor) -> Tensor:
    """Sum over the last axis in numpy's pairwise order (blocks of eight
    partial sums, halves above 128), so a row sums bit-equal to
    ``np.sum`` of the same float64 row.  On the card, whose math already
    rounds otherwise, one reduction (the pairwise order costs a launch
    per block)."""
    if x.is_cuda:
        return x.sum(dim=-1)
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        r = x[..., :8]
        i, stop = 8, n - n % 8
        while i < stop:
            r = r + x[..., i:i + 8]
            i += 8
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for j in range(i, n):
            res = res + x[..., j]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(x[..., :n2]) + _pairwise_sum(x[..., n2:])


def _ufunc(name: str, t: Tensor) -> Tensor:
    """``torch.<name>`` on the card; numpy's ufunc on a CPU tensor, whose
    result is bit-equal to the host numpy estimator (torch's vectorized
    CPU sqrt/log1p/exp round differently in the last place)."""
    if t.is_cuda:
        return getattr(torch, name)(t)
    return torch.from_numpy(getattr(np, name)(t.numpy()))


def _estimate_probs_batch_torch(d0_sq, di_sq, cc_dist, rho_sq, table,
                                valid):
    dev = di_sq.device
    rho = _ufunc("sqrt", torch.clamp(rho_sq, min=1e-30))[:, None]
    h = (di_sq - d0_sq[:, None]) / (2.0 * torch.clamp(cc_dist, min=1e-20))
    t = torch.clamp(h / rho, -1.0, 1.0)
    x = torch.clamp(1.0 - t * t, 0.0, 1.0)
    tbl = table.to(dev) if isinstance(table, torch.Tensor) \
        else torch.tensor(np.asarray(table), device=dev)
    n = tbl.shape[0]
    pos = x * (n - 1)
    lo = torch.clamp(torch.floor(pos).long(), 0, n - 2)
    frac = pos - lo
    half = 0.5 * (tbl[lo] * (1.0 - frac) + tbl[lo + 1] * frac)
    zero = torch.zeros_like(half)
    v = torch.where(t >= 0, half, 1.0 - half)
    v = torch.where(valid, v, zero)
    total = _pairwise_sum(v)
    ok = total > 0
    vn = v / torch.where(ok, total, torch.ones_like(total))[:, None]
    log1m = torch.where(
        valid, _ufunc("log1p", -torch.clamp(vn, 0.0, 1.0 - 1e-7)), zero)
    p0 = _ufunc("exp", _pairwise_sum(log1m[:, 1:]) + log1m[:, 0])
    p0 = torch.where(ok, p0, torch.ones_like(p0))
    p = torch.where(ok[:, None], (1.0 - p0)[:, None] * vn, zero)
    return p0, p


def estimate_probs_batch(d0_sq, di_sq, cc_dist, rho_sq, table, valid):
    """``estimate_probs_np`` lifted to ``(B, M)`` candidate arrays.

    d0_sq (B,); di_sq (B, M); cc_dist (B, M); rho_sq (B,); valid (B, M).
    Convention: column 0 holds each query's nearest candidate and is
    excluded (``valid[:, 0]`` False); under it each float64 row is
    bitwise-identical to a per-row ``estimate_probs_np`` call, on host
    numpy arrays and on CPU torch tensors alike.  Torch tensors on the
    card (the fused planner) use CUDA's math and agree to float rounding.
    ``table`` is the precomputed beta grid or, for numpy only, a
    callable.  Returns (p0 (B,), p (B, M)).
    """
    if not isinstance(di_sq, np.ndarray):
        if callable(table):
            raise TypeError("callable beta tables are host-only; pass the "
                            "precomputed grid for torch tensors")
        return _estimate_probs_batch_torch(d0_sq, di_sq, cc_dist, rho_sq,
                                           table, valid)
    rho = np.sqrt(np.maximum(rho_sq, 1e-30))[:, None]
    h = (di_sq - d0_sq[:, None]) / (2.0 * np.maximum(cc_dist, 1e-20))
    t = np.clip(h / rho, -1.0, 1.0)
    x = np.clip(1.0 - t * t, 0.0, 1.0)
    if callable(table):
        half = 0.5 * np.asarray(table(x), dtype=np.float64)
    else:
        tbl = np.asarray(table)
        n = tbl.shape[0]
        pos = x * (n - 1)
        lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 2)
        frac = pos - lo
        half = 0.5 * (tbl[lo] * (1.0 - frac) + tbl[lo + 1] * frac)
    v = np.where(t >= 0, half, 1.0 - half)
    v = np.where(valid, v, 0.0)
    total = v.sum(axis=1)
    ok = total > 0
    vn = v / np.where(ok, total, 1.0)[:, None]
    # p0 = prod over valid candidates; the tail slice reproduces
    # estimate_probs_np's compacted vn[valid] summation tree under the
    # planner convention, and the column-0 term keeps other masks right
    log1m = np.where(valid, np.log1p(-np.clip(vn, 0.0, 1.0 - 1e-7)), 0.0)
    p0 = np.exp(log1m[:, 1:].sum(axis=1) + log1m[:, 0])
    p0 = np.where(ok, p0, 1.0)
    p = np.where(ok[:, None], (1.0 - p0)[:, None] * vn, 0.0)
    return p0, p


def rho_sq_batch(kth, *, metric: str, q_norm_sq=None, max_norm_sq=None):
    """Running k-th item distance (minimization convention) -> squared
    radius in geometry space: kth for L2, ||q||^2 + M^2 + 2*kth for IP
    (the MIPS-augmented space).  Numpy arrays or torch tensors."""
    if isinstance(kth, np.ndarray):
        if metric == "l2":
            return np.maximum(kth, 0.0)
        return np.maximum(q_norm_sq + max_norm_sq + 2.0 * kth, 0.0)
    if metric == "l2":
        return torch.clamp(kth, min=0.0)
    return torch.clamp(q_norm_sq + max_norm_sq + 2.0 * kth, min=0.0)


# ---------------------------------------------------------------------------
# Host-driven Algorithm 1 (dynamic index path)
# ---------------------------------------------------------------------------

@dataclass
class APSResult:
    ids: np.ndarray            # (k,) item ids
    dists: np.ndarray          # (k,) minimization-convention distances
    scanned: np.ndarray        # partition indices scanned, in scan order
    nprobe: int = 0
    recall_estimate: float = 0.0
    recompute_count: int = 0
    trace: List[float] = field(default_factory=list)


class TopK:
    """Simple numpy top-k accumulator (minimization convention)."""

    def __init__(self, k: int):
        self.k = k
        self.dists = np.full(k, np.inf, dtype=np.float64)
        self.ids = np.full(k, -1, dtype=np.int64)

    def update(self, dists: np.ndarray, ids: np.ndarray) -> None:
        if len(dists) == 0:
            return
        d = np.concatenate([self.dists, dists.astype(np.float64)])
        i = np.concatenate([self.ids, ids.astype(np.int64)])
        if len(d) > self.k:
            sel = np.argpartition(d, self.k - 1)[:self.k]
            sel = sel[np.argsort(d[sel], kind="stable")]
        else:
            sel = np.argsort(d, kind="stable")
        self.dists, self.ids = d[sel], i[sel]

    @property
    def full(self) -> bool:
        return np.isfinite(self.dists[self.k - 1])

    @property
    def kth(self) -> float:
        return float(self.dists[self.k - 1])


def aps_scan(
    *,
    cand_centroid_dists_sq: np.ndarray,   # (M,) ||q - c_i||^2 (geometry space)
    cand_cc_dists: np.ndarray,            # (M,) ||c_i - c_nearest||
    scan_partition: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    item_dist_to_rho_sq: Callable[[float], float],
    k: int,
    recall_target: float,
    table: np.ndarray,
    tau_rho: float = 0.01,
    max_scan: int | None = None,
) -> APSResult:
    """Algorithm 1 over an arbitrary candidate set.  ``scan_partition(m)``
    scans candidate m and returns its (dists, ids); ``item_dist_to_rho_sq``
    maps the k-th item distance to the squared geometry radius."""
    m_total = len(cand_centroid_dists_sq)
    assert m_total >= 1
    order0 = int(np.argmin(cand_centroid_dists_sq))
    heap = TopK(k)
    max_scan = m_total if max_scan is None else min(max_scan, m_total)

    scanned_mask = np.zeros(m_total, dtype=bool)
    scan_order: List[int] = [order0]
    d, i = scan_partition(order0)
    heap.update(d, i)
    scanned_mask[order0] = True

    d0_sq = float(cand_centroid_dists_sq[order0])
    di = np.asarray(cand_centroid_dists_sq, dtype=np.float64)
    cc = np.maximum(np.asarray(cand_cc_dists, dtype=np.float64), 1e-12)
    tbl = table if callable(table) else np.asarray(table, dtype=np.float64)
    valid = np.ones(m_total, dtype=bool)
    valid[order0] = False

    recomputes = 0

    def compute_probs(rho_sq: float) -> Tuple[float, np.ndarray]:
        nonlocal recomputes
        recomputes += 1
        return estimate_probs_np(d0_sq, di, cc, rho_sq, tbl, valid)

    if not heap.full:
        # fewer than k items seen: no radius yet -> keep scanning by
        # centroid-distance order until the heap fills
        p0, probs = 0.0, None
        rho_sq = np.inf
    else:
        rho_sq = item_dist_to_rho_sq(heap.kth)
        p0, probs = compute_probs(rho_sq)

    result = APSResult(ids=heap.ids, dists=heap.dists,
                       scanned=np.asarray(scan_order), nprobe=1,
                       recall_estimate=p0)
    r = p0
    trace = [r]

    while r < recall_target and len(scan_order) < max_scan:
        if probs is None:
            rem = np.where(~scanned_mask)[0]
            nxt = int(rem[np.argmin(cand_centroid_dists_sq[rem])])
        else:
            masked = np.where(scanned_mask, -np.inf, probs)
            nxt = int(np.argmax(masked))
            if masked[nxt] == -np.inf:
                break
        d, i = scan_partition(nxt)
        heap.update(d, i)
        scanned_mask[nxt] = True
        scan_order.append(nxt)

        if heap.full:
            new_rho_sq = item_dist_to_rho_sq(heap.kth)
            if probs is None or (
                    abs(np.sqrt(new_rho_sq) - np.sqrt(rho_sq))
                    > tau_rho * np.sqrt(rho_sq)):
                rho_sq = new_rho_sq
                p0, probs = compute_probs(rho_sq)
        if probs is not None:
            r = p0 + float(np.sum(np.where(scanned_mask & valid, probs, 0.0)))
        trace.append(r)

    result.ids = heap.ids
    result.dists = heap.dists
    result.scanned = np.asarray(scan_order)
    result.nprobe = len(scan_order)
    result.recall_estimate = float(r)
    result.recompute_count = recomputes
    result.trace = trace
    return result
