"""Calibration telemetry: are the paper's two predictive models honest?

Quake steers execution with predictions — the ``LatencyModel`` cost
model (paper Eq. 2) picks maintenance actions and latency budgets, and
the APS ``recall_estimate`` decides when a query may stop scanning.
This tracker continuously compares both against ground truth and
exposes the rolling error as first-class registry metrics, so model
drift shows up on a dashboard instead of as silently missed targets:

* **latency**: predicted scan cost over the partitions actually folded
  (``LatencyModel.predict_scan_ns``) vs the observed scan wall time,
  recorded by ``RoundScheduler`` once per scheduler round.
* **recall**: the served ``recall_estimate`` vs true recall against
  ``IncrementalGroundTruth``, recorded per sampled query by the replay
  harnesses that hold ground truth (``launch/serve.py``,
  ``bench_serving --cell obs-overhead``).

Registry names (docs/observability.md):
``calibration.latency.{samples,rel_err,predicted_s.*,observed_s.*}``
and ``calibration.recall.{samples,abs_err}``.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Optional

from ..sanitize import TrackedLock, note_guarded
from .registry import MetricsRegistry

__all__ = ["CalibrationTracker"]


class CalibrationTracker:
    """Rolling predicted-vs-observed error over a bounded window."""

    def __init__(self, registry: MetricsRegistry, lam=None, window: int = 256):
        self._lock = TrackedLock("CalibrationTracker._lock")
        self.registry = registry
        self.lam = lam                      # LatencyModel or None
        self._lat_err: deque = deque(maxlen=max(1, int(window)))
        self._rec_err: deque = deque(maxlen=max(1, int(window)))

    # -- latency -------------------------------------------------------
    def record_scan(self, sizes, observed_s: float) -> None:
        """One scheduler round: partitions of ``sizes`` were scanned in
        ``observed_s`` wall seconds."""
        if self.lam is None:
            return
        observed = float(observed_s)
        if not math.isfinite(observed) or observed <= 0.0:
            return
        predicted = float(self.lam.predict_scan_ns(sizes)) * 1e-9
        rel = abs(observed - predicted) / observed
        with self._lock:
            note_guarded(self, "_lat_err")
            self._lat_err.append(rel)
            err = sum(self._lat_err) / len(self._lat_err)
        self.registry.update(
            counters={"calibration.latency.samples": 1},
            gauges={"calibration.latency.rel_err": err},
            observations={"calibration.latency.predicted_s": (predicted,),
                          "calibration.latency.observed_s": (observed,)})

    # -- recall --------------------------------------------------------
    def record_recall(self, estimated: float, true: float) -> None:
        """One sampled query: the APS estimate vs brute-force truth."""
        est = float(estimated)
        tru = float(true)
        if not (math.isfinite(est) and math.isfinite(tru)):
            return
        with self._lock:
            note_guarded(self, "_rec_err")
            self._rec_err.append(abs(est - tru))
            err = sum(self._rec_err) / len(self._rec_err)
        self.registry.update(
            counters={"calibration.recall.samples": 1},
            gauges={"calibration.recall.abs_err": err})

    # -- reading -------------------------------------------------------
    def latency_error(self) -> Optional[float]:
        """Rolling mean relative latency error, or None before any sample."""
        with self._lock:
            if not self._lat_err:
                return None
            return sum(self._lat_err) / len(self._lat_err)

    def recall_error(self) -> Optional[float]:
        """Rolling mean absolute recall error, or None before any sample."""
        with self._lock:
            if not self._rec_err:
                return None
            return sum(self._rec_err) / len(self._rec_err)
