"""Thread-safe metrics registry: counters, gauges, and log-bucketed
latency histograms with deterministic percentile snapshots.

Recording is designed for the serving hot path:

* ``MetricsRegistry._lock`` is the **innermost** rank in
  ``repro_torch.sanitize.LOCK_ORDER`` (mirrored in
  ``tools/quakecheck/config.py``), so a counter bump or histogram
  observation is legal while holding any runtime lock and can never
  invert the lock order or touch the engine lock.
* A record is a dict get + add under a short critical section — no
  allocation beyond first use of a name, no device work, no I/O.

Histograms are log-bucketed: bucket ``i`` covers
``[MIN * G**(i-1), MIN * G**i)`` with ``MIN = 1 ns`` and ``G = 2**(1/8)``
(eight buckets per octave), so any reported percentile is within
~4.4 % relative error of the exact order statistic — and is clamped to
the exact observed ``[min, max]`` envelope, making single-sample and
tail snapshots exact.  ``summarize`` is the one shared percentile path
for the repo: every p50/p95/p99 printed by ``launch/serve.py`` or
``benchmarks/bench_serving.py`` routes through the same bucketing, so a
p99 means the same thing everywhere (docs/observability.md).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from ..sanitize import TrackedLock, note_guarded

__all__ = ["Histogram", "MetricsRegistry", "summarize", "to_prometheus"]

_HIST_MIN = 1e-9                      # 1 ns: anything at/below lands in bucket 0
_HIST_GROWTH = 2.0 ** 0.125           # 8 buckets per octave, <=4.4% rel. error
_LOG_GROWTH = math.log(_HIST_GROWTH)

_EMPTY_SNAPSHOT = {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                   "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}


class Histogram:
    """Log-bucketed scalar histogram (not thread-safe on its own; the
    registry serializes access, and the standalone ``summarize`` helper
    is single-threaded).

    Recording is write-optimized: ``observe``/``observe_many`` only
    append the raw value to a pending buffer (one list append per
    sample — the serving hot path records two samples per query, so
    even a ``math.log`` per sample is measurable).  The buffer folds
    into buckets in one vectorized numpy pass every ``_FOLD_AT``
    samples and on every read."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax", "_pending")

    _FOLD_AT = 4096

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._pending: list = []

    def observe(self, value: float) -> None:
        self._pending.append(value)
        if len(self._pending) >= self._FOLD_AT:
            self._fold()

    def observe_many(self, values) -> None:
        """Bulk observe: one buffer extend, folded lazily."""
        p = self._pending
        if isinstance(values, np.ndarray):
            p.extend(values.tolist())
        else:
            p.extend(values)
        if len(p) >= self._FOLD_AT:
            self._fold()

    def _fold(self) -> None:
        """Bucket the pending raw samples in one vectorized pass.
        Truncating the log-ratio matches ``int()`` on positives, so the
        buckets are identical to a per-sample ``math.log`` loop;
        non-finite samples are discarded here, same as a per-sample
        filter would."""
        p = self._pending
        if not p:
            return
        self._pending = []
        arr = np.asarray(p, dtype=np.float64).ravel()
        arr = arr[np.isfinite(arr)]
        if arr.size == 0:
            return
        idx = np.zeros(arr.shape, dtype=np.int64)
        big = arr > _HIST_MIN
        idx[big] = (np.log(arr[big] / _HIST_MIN)
                    / _LOG_GROWTH).astype(np.int64) + 1
        counts = self.counts
        for i, c in zip(*np.unique(idx, return_counts=True)):
            i = int(i)
            counts[i] = counts.get(i, 0) + int(c)
        self.count += int(arr.size)
        self.total += float(arr.sum())
        self.vmin = min(self.vmin, float(arr.min()))
        self.vmax = max(self.vmax, float(arr.max()))

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1], deterministic given the
        observations: geometric midpoint of the covering bucket, clamped
        to the exact observed [min, max]."""
        self._fold()
        if self.count == 0:
            return math.nan
        rank = min(max(q, 0.0), 1.0) * (self.count - 1)
        cum = 0
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum > rank:
                if idx == 0:
                    est = _HIST_MIN
                else:
                    est = _HIST_MIN * _HIST_GROWTH ** (idx - 0.5)
                return min(max(est, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self) -> Dict[str, float]:
        self._fold()
        if self.count == 0:
            return dict(_EMPTY_SNAPSHOT)
        return {"count": self.count, "sum": self.total,
                "min": self.vmin, "max": self.vmax,
                "mean": self.total / self.count,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


def summarize(values: Iterable[float]) -> Dict[str, float]:
    """The shared percentile path over *raw* samples: exact order
    statistics (linear interpolation, ``numpy.percentile`` semantics)
    in the same snapshot shape the registry histograms expose
    (count/sum/min/max/mean/p50/p95/p99).  Streaming histograms must
    bucket (±4.4% relative error at 8 buckets/octave); when the full
    sample list is in hand there is no reason to pay that quantization
    — ratio gates like the obs-overhead cell would otherwise snap to
    whole bucket widths.  Empty input yields zeros."""
    xs = sorted(float(v) for v in values)
    n = len(xs)
    if n == 0:
        return dict(_EMPTY_SNAPSHOT)

    def pct(q: float) -> float:
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])

    total = sum(xs)
    return {"count": n, "sum": total, "min": xs[0], "max": xs[-1],
            "mean": total / n,
            "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}


class MetricsRegistry:
    """Thread-safe registry of named counters, gauges, and histograms.

    Names are stable dotted strings (``serving.latency_s``,
    ``calibration.recall.abs_err`` — see docs/observability.md); the
    snapshot flattens histograms to ``<name>.p50`` etc.
    """

    def __init__(self):
        self._lock = TrackedLock("MetricsRegistry._lock")
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- recording -----------------------------------------------------
    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            note_guarded(self, "_counters")
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            note_guarded(self, "_gauges")
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            note_guarded(self, "_histograms")
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(value)

    def update(self, counters: Optional[Mapping[str, float]] = None,
               gauges: Optional[Mapping[str, float]] = None,
               observations: Optional[Mapping[str, Iterable[float]]] = None,
               ) -> None:
        """Batched recording under ONE lock acquisition — the hot-path
        entry point.  ``TrackedLock.acquire`` carries lock-order and
        contention accounting, so per-sample ``inc``/``observe`` calls
        from a per-flush loop are measurably more expensive than one
        ``update`` with the samples batched (the obs-overhead bench
        cell gates exactly this).  ``observations`` values are
        iterables of samples."""
        with self._lock:
            note_guarded(self, "_counters")
            if counters:
                for name, n in counters.items():
                    self._counters[name] = self._counters.get(name, 0) + n
            if gauges:
                for name, v in gauges.items():
                    self._gauges[name] = float(v)
            if observations:
                for name, values in observations.items():
                    h = self._histograms.get(name)
                    if h is None:
                        h = self._histograms[name] = Histogram()
                    h.observe_many(values)

    # -- reading -------------------------------------------------------
    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, math.nan)

    def histogram(self, name: str) -> Dict[str, float]:
        with self._lock:
            h = self._histograms.get(name)
            return h.snapshot() if h is not None else dict(_EMPTY_SNAPSHOT)

    def snapshot(self) -> Dict[str, float]:
        """One coherent flat dict: counters and gauges verbatim,
        histograms expanded to ``<name>.{count,sum,min,max,mean,p50,p95,p99}``."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            for name, h in self._histograms.items():
                for k, v in h.snapshot().items():
                    out[f"{name}.{k}"] = v
        return out


def to_prometheus(flat: Mapping[str, object], prefix: str = "quake") -> str:
    """Render a flat metrics dict as Prometheus text exposition.  Dotted
    names map to ``<prefix>_<name with non-alnum -> _>``; non-numeric and
    non-finite values are skipped (the JSON dump keeps them)."""
    lines = []
    for name in sorted(flat):
        v = flat[name]
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue
        if not math.isfinite(float(v)):
            continue
        metric = prefix + "_" + re.sub(r"[^a-zA-Z0-9_]", "_", str(name))
        lines.append(f"{metric} {float(v):.9g}")
    return "\n".join(lines) + "\n"
