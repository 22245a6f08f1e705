"""End-to-end observability for the serving stack (docs/observability.md).

Three pieces, bundled by :class:`Observability` and wired into
``ServingRuntime`` when ``ServingConfig.metrics`` is on:

* :class:`~repro_torch.obs.registry.MetricsRegistry` — counters, gauges, and
  log-bucketed latency histograms behind the innermost-ranked lock.
* :class:`~repro_torch.obs.tracing.QueryTracer` — per-query trace spans
  (admit → queue-wait → flush → per-round scan → terminal status) in a
  bounded ring, dumpable as JSON-lines.
* :class:`~repro_torch.obs.calibration.CalibrationTracker` — rolling
  predicted-vs-observed latency error and estimated-vs-true recall
  error, the feedback signal for the paper's two predictive models.

``summarize`` is the repo's single shared percentile path; everything
that reports a p50/p95/p99 routes through it.
"""
from __future__ import annotations

from .calibration import CalibrationTracker
from .registry import Histogram, MetricsRegistry, summarize, to_prometheus
from .tracing import QueryTracer

__all__ = ["CalibrationTracker", "Histogram", "MetricsRegistry",
           "Observability", "QueryTracer", "summarize", "to_prometheus"]


class Observability:
    """The per-runtime bundle: one registry, one tracer, one tracker."""

    def __init__(self, lam=None, trace_capacity: int = 1024,
                 calibration_window: int = 256):
        self.metrics = MetricsRegistry()
        self.tracer = QueryTracer(capacity=trace_capacity)
        self.calibration = CalibrationTracker(
            self.metrics, lam=lam, window=calibration_window)
