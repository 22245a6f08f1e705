"""Deterministic fault injection for the serving stack.

The serving runtime promises that every admitted query reaches exactly
one terminal status and that the index survives component failures
(docs/serving.md, "Failure semantics").  Promises like that are only as
good as the harness that exercises them, so this module provides the
seeded injector that tests and ``bench_serving --chaos`` wire into
:class:`repro_torch.core.serving.ServingRuntime`.

Sites (``FaultInjector.SITES``), one per failure the runtime must
survive:

  ``scan``          the round scan backend raises (device OOM, kernel
                    bug, host BLAS failure) — the scheduler retries with
                    capped exponential backoff, then fails the affected
                    in-flight batch with ``FAILED`` results.
  ``slow_round``    a round stalls for ``delay_s`` (straggler device /
                    noisy neighbor) — queries with latency budgets
                    retire ``PARTIAL`` instead of waiting the stall out.
  ``maintenance``   the maintainer crashes mid-recluster, after split /
                    merge commits have already mutated the index — the
                    runtime rolls back to the pre-pass checkpoint
                    (index version unchanged) and the next drift trigger
                    retries.
  ``cache``         the result-cache backend raises — the runtime
                    degrades to cache-off mode instead of erroring the
                    query that happened to probe it.
  ``ticker``        the background deadline ticker's tick raises — the
                    ticker survives (counted), and a dead ticker thread
                    is restarted on the next admission.

Durability I/O sites (``core/durability.py``, docs/durability.md) —
these model *crashes*, not transient errors; after one fires the WAL
tail is damaged and the process under test is considered dead until it
recovers:

  ``wal_torn_write``       a crash mid-append: a strict prefix of the
                           framed record reaches the file, then
                           :class:`InjectedFault` — recovery must
                           truncate back to the last valid frame.
  ``wal_corrupt_record``   a bit flip in the written frame (bad sector)
                           — the CRC rejects it and recovery lands on
                           the prefix before it.
  ``ckpt_crash_before_rename``  the checkpoint temp directory is fully
                           written and fsynced but the process dies
                           before the atomic rename — recovery must
                           fall back to the previous generation.
  ``fsync_dropped``        fsync silently does nothing (lying disk /
                           dropped barrier); no exception — the damage
                           only shows at the next simulated crash,
                           which loses the unsynced tail.

Determinism: each site draws from its own ``numpy`` generator seeded by
``(seed, site)``, so whether the N-th *arrival at a site* fires is
reproducible regardless of how threads interleave across sites.  A
``threading.Lock`` keeps each per-site stream internally ordered.

``sleep_fn`` lets fake-clock tests advance virtual time instead of
actually sleeping (both for ``slow_round`` stalls and for the
scheduler's retry backoff).
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["FaultInjector", "InjectedFault"]


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultInjector.check` when a site fires."""

    def __init__(self, site: str, n: int):
        super().__init__(f"injected fault at site {site!r} (trip #{n})")
        self.site = site
        self.n = n


class FaultInjector:
    """Seeded, site-registered fault source.

    ``rates`` maps site name -> probability per arrival in [0, 1]
    (sites absent from the map never fire; rate 1.0 fires on every
    arrival — how the chaos tests make maintenance crash
    deterministically).  ``delay_s`` is the stall injected when
    ``slow_round`` fires.
    """

    SITES = ("scan", "slow_round", "maintenance", "cache", "ticker",
             "wal_torn_write", "wal_corrupt_record",
             "ckpt_crash_before_rename", "fsync_dropped")

    def __init__(self, seed: int = 0, rates: Optional[Dict[str, float]] = None,
                 delay_s: float = 0.0,
                 sleep_fn: Callable[[float], None] = time.sleep):
        rates = dict(rates or {})
        unknown = set(rates) - set(self.SITES)
        if unknown:
            raise ValueError(f"unknown fault sites: {sorted(unknown)} "
                             f"(known: {list(self.SITES)})")
        self.seed = seed
        self.rates = rates
        self.delay_s = float(delay_s)
        self.sleep_fn = sleep_fn
        self._mu = threading.Lock()
        # per-site generators: the draw sequence at one site is a pure
        # function of (seed, site, arrival ordinal), independent of what
        # other sites saw in between
        self._rng = {s: np.random.default_rng(
            [seed, zlib.crc32(s.encode())]) for s in self.SITES}
        self.draws = {s: 0 for s in self.SITES}
        self.trips = {s: 0 for s in self.SITES}

    def fire(self, site: str) -> bool:
        """One arrival at ``site``; True when the fault fires."""
        rate = self.rates.get(site, 0.0)
        with self._mu:
            self.draws[site] += 1
            if rate <= 0.0:
                return False
            hit = (rate >= 1.0
                   or float(self._rng[site].random()) < rate)
            if hit:
                self.trips[site] += 1
            return hit

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` when ``site`` fires."""
        if self.fire(site):
            with self._mu:
                n = self.trips[site]
            raise InjectedFault(site, n)

    def stall(self, site: str = "slow_round") -> float:
        """Sleep ``delay_s`` (via ``sleep_fn``) when ``site`` fires;
        returns the injected delay (0.0 when it did not fire)."""
        if self.fire(site) and self.delay_s > 0.0:
            self.sleep_fn(self.delay_s)
            return self.delay_s
        return 0.0

    def counters(self) -> dict:
        """Snapshot of per-site arrival and trip counts."""
        with self._mu:
            return {"draws": dict(self.draws), "trips": dict(self.trips)}


def index_state_fingerprint(index) -> bytes:
    """Deterministic digest of an index's logical state.  Two indexes
    that served the same surviving operation stream — e.g. a chaos run
    whose maintenance crashes all rolled back vs a fault-free replay,
    or a crash-recovered index vs a replay of its recovered write
    prefix — must produce identical digests (the recovery acceptance
    checks in tests/test_serving_chaos.py, tests/test_durability.py,
    and ``bench_serving --cell chaos,durability``).

    Canonical-ordering contract (what makes the digest stable):

    * Levels are hashed top-down in list order; per level, the centroid
      matrix is hashed **verbatim** (contiguous float64) — partition
      *numbering* is physical state, not presentation, because it feeds
      ``kmeans.assign`` tie-breaks when routing future inserts.
    * Upper levels hash each child array **sorted**: child-set
      membership is logical state, but the in-array order is not hashed
      here (it is preserved exactly by checkpoints for replay
      determinism; see durability.write_checkpoint).
    * Base-level partitions hash ``(ids sorted ascending, vectors
      re-ordered to match)`` — so the *arrival order* of rows inside a
      partition is canonicalized away.  Insert/delete sequences that
      commute (touch disjoint ids and route to the same partitions)
      therefore fingerprint identically regardless of interleaving.
    * Everything else — sqnorms, journal, partition stats, maintenance
      log, caches — is derived or session state and is deliberately
      excluded; save/load round-trips must preserve the digest
      (tests/test_durability.py::test_fingerprint_*).

    Vectors and centroids are hashed as float64 *widenings* of their
    stored float32 values, which is exact, so a digest match means
    bit-identical stored state."""
    import hashlib
    h = hashlib.sha256()
    for level in index.levels:
        h.update(np.ascontiguousarray(
            level.centroids, dtype=np.float64).tobytes())
        if level.vectors is None:
            for child in level.children:
                h.update(np.sort(np.asarray(child)).tobytes())
            continue
        for j in range(level.num_partitions):
            ids = np.asarray(level.ids[j])
            order = np.argsort(ids, kind="stable")
            h.update(ids[order].tobytes())
            h.update(np.ascontiguousarray(
                level.vectors[j][order], dtype=np.float64).tobytes())
    return h.digest()
