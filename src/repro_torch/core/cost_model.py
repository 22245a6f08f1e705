"""Quake's query-latency cost model (paper §4.1).

    C = sum_l sum_j  A_lj * lambda(s_lj)

``lambda(s)`` is the latency of scanning a partition of ``s`` vectors,
non-linear in ``s`` because of top-k selection: the analytic default is
lambda(s) = c_f + c_lin*s + c_sel*s*log2(s) (ns).  All cost math is plain
numpy: maintenance is a host-side control plane.  Profiling the scan on
the card (the paper's offline profiling step) comes with the
maintenance port.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np


@dataclass(frozen=True)
class LatencyModel:
    """lambda(s): scan latency (ns) for a partition of s vectors."""
    c_fixed: float = 200.0       # per-partition dispatch overhead
    c_lin: float = 1.5           # per-vector memory/FMA term (ns/vector)
    c_sel: float = 0.25          # selection term coefficient (ns/vector/log2)
    dim: int = 0                 # informational: profiled dimensionality

    def __call__(self, s) -> np.ndarray:
        s = np.asarray(s, dtype=np.float64)
        logs = np.log2(np.maximum(s, 2.0))
        lat = self.c_fixed + self.c_lin * s + self.c_sel * s * logs
        return np.where(s > 0, lat, 0.0)

    def scaled(self, factor: float) -> "LatencyModel":
        return replace(self, c_fixed=self.c_fixed * factor,
                       c_lin=self.c_lin * factor, c_sel=self.c_sel * factor)

    def predict_scan_ns(self, sizes) -> float:
        """Predicted wall time (ns) of one scan over partitions of the
        given sizes: Eq. (2) with A=1 per scanned partition."""
        s = np.asarray(sizes, dtype=np.float64)
        if s.size == 0:
            return 0.0
        return float(np.sum(self(s)))


@dataclass
class PartitionStats:
    """Per-level tracking of access frequencies over the sliding window W
    (paper Stage 0).  ``hits`` counts queries that scanned each partition;
    ``window`` counts queries seen since the last reset."""
    hits: np.ndarray = field(default_factory=lambda: np.zeros(0))
    window: int = 0

    def ensure(self, n: int) -> None:
        if len(self.hits) < n:
            self.hits = np.concatenate(
                [self.hits, np.zeros(n - len(self.hits))])

    def record(self, scanned: np.ndarray) -> None:
        self.hits[scanned] += 1
        self.window += 1

    def record_batch(self, parts: np.ndarray, counts: np.ndarray,
                     n_queries: int) -> None:
        """Batched Stage-0 update: ``counts[i]`` queries scanned partition
        ``parts[i]`` out of ``n_queries`` served."""
        self.hits[parts] += np.asarray(counts, dtype=np.float64)
        self.window += int(n_queries)

    def boost(self, parts: np.ndarray, freq: float) -> None:
        """Bump partitions' access frequency by ``freq``."""
        self.hits[parts] += freq * max(self.window, 1)

    def access_freq(self, n: int, default: float = 0.0) -> np.ndarray:
        """A_lj in [0,1]; ``default`` is used before any query arrives."""
        self.ensure(n)
        if self.window == 0:
            return np.full(n, default)
        return self.hits[:n] / self.window

    def reset(self) -> None:
        self.hits[:] = 0
        self.window = 0

    def split(self, j: int, alpha: float) -> None:
        """Partition j split into (j, new_last): children inherit alpha*A."""
        h = self.hits[j] * alpha
        self.hits[j] = h
        self.hits = np.append(self.hits, h)

    def remove(self, j: int) -> None:
        """Partition j deleted; swap-remove to match index storage layout."""
        self.hits[j] = self.hits[-1]
        self.hits = self.hits[:-1]
