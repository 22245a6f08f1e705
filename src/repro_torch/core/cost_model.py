"""Quake's query-latency cost model (paper §4.1).

    C = sum_l sum_j  A_lj * lambda(s_lj)

``lambda(s)`` is the latency of scanning a partition of ``s`` vectors,
non-linear in ``s`` because of top-k selection: the analytic default is
lambda(s) = c_f + c_lin*s + c_sel*s*log2(s) (ns).  ``profile`` replaces
the defaults with a least-squares fit to the port's own scan timed on the
index's device (the paper's offline profiling step).  All cost math is
plain numpy: maintenance is a host-side control plane.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..kernels import ops
from .device import resolve_device


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


def fit_latency_model(sizes: np.ndarray, lats_ns: np.ndarray,
                      dim: int = 0) -> LatencyModel:
    """Least-squares fit of (c_fixed, c_lin, c_sel) to measured latencies,
    each coefficient clipped at 0."""
    s = np.asarray(sizes, dtype=np.float64)
    y = np.asarray(lats_ns, dtype=np.float64)
    A = np.stack([np.ones_like(s), s, s * np.log2(np.maximum(s, 2.0))], 1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    coef = np.maximum(coef, 0.0)
    return LatencyModel(float(coef[0]), float(coef[1]), float(coef[2]), dim)


WARMUP = 3          # untimed calls per size before the timed ones
SPIN_MS = 20.0      # device spin ahead of the timed calls (at least)


def _device_ms(fn, repeats: int, dev: torch.device) -> float:
    """Device time of ``repeats`` calls of ``fn``.  The calls are enqueued
    while a spin kernel holds the device, so the CUDA events bracket the
    device's work only, not the host's dispatch (which varies from host to
    host and is not a property of the scan).  The spin is lengthened until
    the host finishes enqueueing before it ends."""
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    spin.record()
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda.synchronize(dev)
    cycles_per_ms = 1_000_000 / max(spin.elapsed_time(start), 1e-3)
    spin_ms = SPIN_MS
    for _ in range(6):
        torch.cuda.synchronize(dev)
        spin.record()
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if enqueue_ms < spin.elapsed_time(start):
            return start.elapsed_time(end)
        spin_ms = 2 * enqueue_ms
    raise RuntimeError("the host could not enqueue the timed calls ahead "
                       "of the device")


def profile(dim: int, k: int = 100, sizes=(64, 256, 1024, 4096, 16384),
            repeats: int = 5, seed: int = 0, device="cuda",
            batch: int = 1) -> LatencyModel:
    """Offline profiling of the scan on ``device`` (the paper's offline
    profiling step): ``ops.scan_topk`` of ``batch`` queries against ``s``
    vectors (on the card the ``scan_topk`` CUDA kernel), ``WARMUP``
    untimed calls then ``repeats`` timed ones per size, and a fit of
    lambda to the time per query.  ``batch=1`` is the per-query scan, as
    in the JAX package; a serving batch (the batched executor's B) gives
    the cost one query pays for a partition when B queries share its
    scan.  On the card the time is the device's (CUDA events, host
    dispatch hidden: ``_device_ms``); on the CPU it is the host clock."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(batch, dim)).astype(np.float32),
                        device=dev)
    lats = []
    for s in sizes:
        x = torch.as_tensor(rng.normal(size=(s, dim)).astype(np.float32),
                            device=dev)
        kk = min(k, s)

        def scan():
            ops.scan_topk(q, x, kk)
        for _ in range(WARMUP):
            scan()
        if dev.type == "cuda":
            total_ns = _device_ms(scan, repeats, dev) * 1e6
        else:
            t0 = time.perf_counter()
            for _ in range(repeats):
                scan()
            total_ns = (time.perf_counter() - t0) * 1e9
        lats.append(total_ns / (repeats * batch))
    return fit_latency_model(np.asarray(sizes), np.asarray(lats), dim)


def paper_tau_ns(lam: LatencyModel) -> float:
    """The paper's commit threshold rescaled to ``lam``: tau = 250 ns
    against a profile with lambda(500) = 1.2e6 ns (§8.1), so the same
    small fraction of one partition scan."""
    return float(250.0 * lam(500) / 1.2e6)


def total_cost(lam: LatencyModel, sizes_per_level, freqs_per_level) -> float:
    """Paper Eq. (2): C = sum_l sum_j A_lj * lambda(s_lj)  (ns/query)."""
    c = 0.0
    for sizes, freqs in zip(sizes_per_level, freqs_per_level):
        c += float(np.sum(np.asarray(freqs) * lam(np.asarray(sizes))))
    return c


def split_delta_estimate(lam: LatencyModel, n_l: int, size: float,
                         freq: float, alpha: float) -> float:
    """Paper Eq. (6): Delta'Split = DeltaO+ - A*lam(s) + 2*alpha*A*lam(s/2)."""
    d_over = lam(n_l + 1) - lam(n_l)
    return float(d_over - freq * lam(size) + 2 * alpha * freq * lam(size / 2))


def split_delta_verify(lam: LatencyModel, n_l: int, size_before: float,
                       freq: float, size_l: float, size_r: float,
                       alpha: float) -> float:
    """Paper Eq. (4) with measured child sizes but Stage-1 frequency
    assumptions (A_child = alpha * A_parent)."""
    d_over = lam(n_l + 1) - lam(n_l)
    return float(d_over - freq * lam(size_before)
                 + alpha * freq * (lam(size_l) + lam(size_r)))


def merge_delta_estimate(lam: LatencyModel, n_l: int, size: float,
                         freq: float, recv_sizes: np.ndarray,
                         recv_freqs: np.ndarray) -> float:
    """Merge estimate with uniform redistribution over the receivers
    (paper Eq. (5) with ds_m = s/|R|, dA_m = A/|R|)."""
    r = max(len(recv_sizes), 1)
    d_over = lam(n_l - 1) - lam(n_l)
    ds, da = size / r, freq / r
    bump = np.sum((recv_freqs + da) * lam(recv_sizes + ds)
                  - recv_freqs * lam(recv_sizes))
    return float(d_over - freq * lam(size) + bump)


def merge_delta_verify(lam: LatencyModel, n_l: int, size: float, freq: float,
                       recv_sizes_before: np.ndarray,
                       recv_sizes_after: np.ndarray,
                       recv_freqs: np.ndarray, recv_extra_freq: np.ndarray,
                       ) -> float:
    """Paper Eq. (5) with the actual receiver set and measured sizes."""
    d_over = lam(n_l - 1) - lam(n_l)
    bump = np.sum((recv_freqs + recv_extra_freq) * lam(recv_sizes_after)
                  - recv_freqs * lam(recv_sizes_before))
    return float(d_over - freq * lam(size) + bump)
