"""Online serving runtime: micro-batching queue, cross-batch union riding,
query-aware result caching, drift-triggered maintenance (paper §3's
continuously running serving loop, made a first-class subsystem) — the
port of the JAX package's ``core/serving.py``.  On a CUDA index every
round of the served path is one packed scan through the indexed-scan
kernel (``scan_backend="auto"`` picks ``"device"`` there); the host
backend runs only when the caller asks for it or the index is on the
CPU.

The paper's headline numbers come from an *online* system that interleaves
skewed queries, updates and cost-model maintenance.  The pieces below turn
the batched executor (``core/multiquery.py``) into that system:

  * **Micro-batching queue** — single queries and query batches are
    admitted into a bounded queue and coalesced into executor batches
    (size- or deadline-triggered flush, explicit ``flush``/``drain`` for
    replay drivers).  Coalescing only changes *when* work runs,
    never what a query scans: plans are per-query and the calibrated APS
    radius is pinned per snapshot fingerprint by a deterministic
    resident-sample calibration (``calibrate_radius_resident``), so the
    same operation stream yields the same results under any flush timing
    — top-k id sets exactly, distances to scan-arithmetic (f32)
    rounding (the coalescing-determinism contract; ``docs/serving.md``).
  * **Cross-batch union riding** — the :class:`RoundScheduler`
    generalizes ``run_round_loop``'s live-mask/union machinery to a
    *changing* query population: queries admitted while earlier batches
    are mid-rounds join the next round, and every round's partition
    union is shared across all in-flight batches — when a newcomer's
    planned probes overlap partitions an in-flight plan is about to
    stream, the partition block streams once and serves both.  Within
    one co-admitted group a partition streams at most once (the same
    guarantee ``run_round_loop`` gives one batch), and the streamed
    footprint never exceeds the union of the per-batch fixed plans (the
    riding-footprint invariant).
  * **Query-aware result cache** — :class:`ResultCache` keys normalized
    queries by sign-LSH code (or exact bytes), verifies hits against the
    stored exemplar within a tolerance, and invalidates per partition
    from the index's mutation journal: an entry remembers its planned
    probe footprint, and any journal delta dirtying one of those
    partitions (or any structural change) drops it — the QVCache policy
    on top of the journal's invalidation protocol.
  * **Drift-triggered maintenance** — :class:`MaintenanceScheduler`
    replaces run-after-every-op with triggers: journal dirty mass,
    cost-model drift, and access-histogram shift over the served-batch
    access frequencies the scheduler feeds back into
    ``PartitionStats`` (Stage 0) — the batched scan path otherwise
    bypasses the statistics the cost model plans with.

``ServingRuntime`` composes the four and is what ``launch/serve.py``
drives.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..faults import FaultInjector
from ..kernels.ref import MASK_DIST
from ..obs import Observability
from ..sanitize import (TrackedLock, allow_sync, check_finite,
                        note_guarded, observability_counters)
from . import aps as aps_mod
from . import multiquery as mq
from .cost_model import LatencyModel
from .durability import DurabilityManager, RecoveryReport, recover_index
from .index import QuakeIndex
from .maintenance import (Maintainer, MaintenanceReport, checkpoint_index,
                          restore_index)

__all__ = ["ServingConfig", "ServingRuntime", "QueryResult", "ResultCache",
           "MaintenanceScheduler", "MaintenanceTriggers", "RoundScheduler",
           "calibrate_radius_resident", "STATUS_OK", "STATUS_PARTIAL",
           "STATUS_SHED", "STATUS_FAILED", "TERMINAL_STATUSES"]

logger = logging.getLogger("repro_torch.serving")

# Terminal query statuses (docs/serving.md failure semantics): every
# admitted query reaches exactly one of these — no query ever vanishes.
STATUS_OK = "OK"            # full planned search completed
STATUS_PARTIAL = "PARTIAL"  # latency budget expired; running top-k returned
STATUS_SHED = "SHED"        # dropped by admission control, never searched
STATUS_FAILED = "FAILED"    # scan backend failed after retries
TERMINAL_STATUSES = (STATUS_OK, STATUS_PARTIAL, STATUS_SHED, STATUS_FAILED)


@dataclass
class ServingConfig:
    """Knobs for one :class:`ServingRuntime`.

    Deadline precedence: ``flush_deadline_ms`` (milliseconds) **wins**
    over ``flush_deadline`` (seconds) whenever both are set —
    ``__post_init__`` folds the milliseconds knob into
    ``flush_deadline``, so runtime code only ever reads the seconds
    field.  Both are validated at construction: a zero or negative
    deadline is a configuration error (it would make every admission
    flush immediately, silently disabling micro-batching), not a
    "flush never" sentinel — that sentinel is ``None``.
    """
    k: int = 10
    recall_target: Optional[float] = None  # None -> index.config.recall_target
    rounds: Optional[int] = None       # per-query probe-round budget
                                       # (None = as many geometric rounds
                                       # as the plan needs)
    early_exit: bool = False           # retire queries whose refined APS
                                       # estimate clears the target before
                                       # their plan is exhausted.  Scans
                                       # less, but exit points depend on
                                       # what rode alongside — trades the
                                       # strict coalescing-determinism
                                       # contract for footprint savings.
    flush_size: int = 64               # queued queries that force a flush
    flush_deadline: Optional[float] = None  # seconds the oldest queued
                                       # query may wait before an
                                       # admission (or the background
                                       # ticker) forces a flush (None =
                                       # size-triggered / explicit only)
    flush_deadline_ms: Optional[float] = None  # same knob in ms; wins
                                       # over flush_deadline when set
    ticker: bool = True                # run the background deadline
                                       # ticker thread when a deadline
                                       # is configured (off for
                                       # fake-clock tests, which call
                                       # tick() themselves)
    record_admissions: bool = False    # keep a totally ordered admission
                                       # log (engine-lock order) for
                                       # single-threaded replay of a
                                       # concurrent run
    interleave_rounds: int = 1         # scheduler rounds run per flush (the
                                       # in-flight window newcomers ride)
    b_bucket: int = 16                 # active-row padding bucket (bounds
                                       # distinct jitted scan shapes)
    storage_dtype: str = "f32"         # executor snapshot format
    impl: str = "auto"                 # scan kernel implementation
    planner: str = "vectorized"        # APS batch planner variant
    scan_backend: str = "auto"         # "device": packed snapshot scans
                                       # (scan_probe_round — the
                                       # indexed-scan kernel on the
                                       # card); "host": per-partition
                                       # GEMMs over the index's ragged
                                       # buffers (the CPU fast path —
                                       # write barriers freeze the index
                                       # within an epoch, so the live
                                       # buffers are snapshot-coherent);
                                       # "auto" picks device on a CUDA
                                       # index, host otherwise
    # --- result cache (0 entries disables) ---
    cache_entries: int = 0
    cache_bits: int = 0                # sign-LSH key bits; 0 = exact bytes
    cache_tol: float = 0.0             # exemplar L2 tolerance.  0 = exact
                                       # query match only (preserves the
                                       # coalescing-determinism contract:
                                       # an identical repeat always maps
                                       # to the same result).  > 0 serves
                                       # *near*-duplicates the exemplar's
                                       # top-k — whether the exemplar
                                       # completed before the repeat
                                       # arrived depends on flush timing,
                                       # so approximate caching, like
                                       # early_exit, trades the strict
                                       # determinism contract away
    cache_seed: int = 0
    record_stats: bool = True          # feed served access frequencies
                                       # into PartitionStats (off for
                                       # warm-up / shadow runtimes)
    # --- maintenance triggers ---
    maint_min_ops: int = 4
    maint_dirty_frac: float = 0.25
    maint_cost_drift: float = 0.15
    maint_access_shift: float = 0.6
    maint_max_ops: Optional[int] = 64
    # --- durability (core/durability.py, docs/durability.md) ---
    wal_dir: Optional[str] = None      # WAL + checkpoint directory; None
                                       # disables durability (everything
                                       # stays memory-resident)
    fsync: str = "batch"               # WAL fsync policy: "always" (per
                                       # append), "batch" (every
                                       # wal_batch_ops appends), "off"
                                       # (flush to OS only — a crash may
                                       # lose the whole unsynced tail)
    wal_batch_ops: int = 32            # fsync cadence under "batch"
    ckpt_every_ops: Optional[int] = 256  # checkpoint every N logged write
                                       # ops (None = only the attach
                                       # baseline and forced /
                                       # post-maintenance checkpoints)
    keep_checkpoints: int = 2          # generations retained after prune
    # --- per-query latency budgets (docs/serving.md failure semantics) ---
    deadline_s: Optional[float] = None  # default per-query budget; a query
                                       # whose budget expires retires at
                                       # the end of the current round with
                                       # its running top-k, status PARTIAL
                                       # (submit_query's deadline_s arg
                                       # overrides per query; None = no
                                       # budget)
    # --- admission control / load shedding ---
    queue_cap: Optional[int] = None    # max queued (not yet admitted)
                                       # queries; None = unbounded
    queue_policy: str = "block"        # on a full queue: "block" (the
                                       # submitter pays for a flush, then
                                       # retries — backpressure),
                                       # "shed-oldest" (evict the oldest
                                       # queued query with an immediate
                                       # SHED result, admit the newcomer),
                                       # "shed-newest" (SHED the newcomer)
    # --- degradation governor ---
    govern: bool = False               # under sustained queue pressure,
                                       # step the effective recall target
                                       # down / tighten per-query probe
                                       # budgets; restore on recovery
    govern_high: float = 0.75          # flush-batch fill fraction of
                                       # queue_cap that counts as pressure
    govern_low: float = 0.25           # fill fraction that counts as calm
    govern_patience: int = 2           # consecutive pressured (calm)
                                       # flushes before a degrade
                                       # (restore) step
    govern_step: float = 0.05          # recall-target reduction per step
    govern_max_steps: int = 4
    govern_min_target: float = 0.5     # floor for the effective target
    govern_probe_frac: float = 0.7     # per-step multiplicative cap on
                                       # per-query probe budgets (the
                                       # serving-layer union_cap analog:
                                       # plans are truncated to this
                                       # fraction of their probe count)
    # --- scan-fault retry (capped exponential backoff) ---
    scan_retries: int = 2              # retries per failed round scan
                                       # before the in-flight batch fails
    scan_backoff_s: float = 0.001      # first-retry backoff; doubles per
                                       # attempt ...
    scan_backoff_max_s: float = 0.05   # ... up to this cap
    # --- observability (obs/, docs/observability.md) ---
    metrics: bool = True               # wire the Observability bundle
                                       # (metrics registry + per-query
                                       # trace spans + calibration
                                       # tracker) into the runtime.  Off:
                                       # every hook is a None check —
                                       # results are byte-identical either
                                       # way (a test asserts it)
    trace_capacity: int = 1024         # completed trace spans retained in
                                       # the tracer's ring buffer
    calibration_window: int = 256      # rolling window (samples) for the
                                       # predicted-vs-observed calibration
                                       # error gauges

    def __post_init__(self) -> None:
        if self.flush_deadline is not None and self.flush_deadline <= 0:
            raise ValueError(
                f"flush_deadline must be positive (got "
                f"{self.flush_deadline}); use None for size-triggered/"
                f"explicit flushes only")
        if self.flush_deadline_ms is not None:
            if self.flush_deadline_ms <= 0:
                raise ValueError(
                    f"flush_deadline_ms must be positive (got "
                    f"{self.flush_deadline_ms}); use None for "
                    f"size-triggered/explicit flushes only")
            self.flush_deadline = self.flush_deadline_ms / 1000.0
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive "
                             f"(got {self.deadline_s})")
        if self.queue_cap is not None and self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1 "
                             f"(got {self.queue_cap})")
        if self.queue_policy not in ("block", "shed-oldest", "shed-newest"):
            raise ValueError(f"queue_policy must be block/shed-oldest/"
                             f"shed-newest, got {self.queue_policy!r}")
        if not 0.0 < self.govern_low <= self.govern_high <= 1.0:
            raise ValueError(
                f"governor thresholds need 0 < govern_low <= govern_high "
                f"<= 1 (got {self.govern_low}, {self.govern_high})")
        if self.govern_patience < 1 or self.govern_max_steps < 1:
            raise ValueError("govern_patience and govern_max_steps "
                             "must be >= 1")
        if not 0.0 < self.govern_probe_frac <= 1.0:
            raise ValueError(f"govern_probe_frac must be in (0, 1] "
                             f"(got {self.govern_probe_frac})")
        if self.scan_retries < 0 or self.scan_backoff_s < 0 \
                or self.scan_backoff_max_s < 0:
            raise ValueError("scan retry/backoff knobs must be "
                             "non-negative")
        if self.fsync not in ("always", "batch", "off"):
            raise ValueError(f"fsync must be always/batch/off, "
                             f"got {self.fsync!r}")
        if self.wal_batch_ops < 1:
            raise ValueError(f"wal_batch_ops must be >= 1 "
                             f"(got {self.wal_batch_ops})")
        if self.ckpt_every_ops is not None and self.ckpt_every_ops < 1:
            raise ValueError(f"ckpt_every_ops must be >= 1 or None "
                             f"(got {self.ckpt_every_ops})")
        if self.keep_checkpoints < 1:
            raise ValueError(f"keep_checkpoints must be >= 1 "
                             f"(got {self.keep_checkpoints})")
        if self.trace_capacity < 1:
            raise ValueError(f"trace_capacity must be >= 1 "
                             f"(got {self.trace_capacity})")
        if self.calibration_window < 1:
            raise ValueError(f"calibration_window must be >= 1 "
                             f"(got {self.calibration_window})")


@dataclass
class QueryResult:
    """Per-query serving outcome (the single-row mirror of
    ``multiquery.BatchResult``).

    ``status`` is terminal: ``OK`` (full planned search), ``PARTIAL``
    (latency budget expired — ``ids``/``dists`` are the running top-k at
    the end of the last round and ``recall_estimate`` is the round
    loop's refined APS estimate over what was actually scanned, 0.0
    when the top-k never filled), ``SHED`` (dropped by admission
    control, never searched) or ``FAILED`` (scan backend failed after
    retries; ``error`` carries the cause).  Every admitted query gets
    exactly one — docs/serving.md, failure semantics."""
    ids: np.ndarray                 # (k,) external ids, -1 on misses
    dists: np.ndarray               # (k,) minimization convention
    nprobe: int = 0                 # partitions this query consumed
    recall_estimate: float = np.nan
    rounds: int = 0                 # scan rounds the query took cells in
    from_cache: bool = False
    latency_s: float = 0.0          # submit -> result wall time
    status: str = STATUS_OK         # terminal status (see above)
    error: str = ""                 # failure cause (FAILED only)
    t_submit: float = 0.0           # admission clock value (trace spans)
    batch: int = -1                 # coalesced admission group, -1 if
                                    # the query never reached the
                                    # scheduler (cache hit / shed)


def calibrate_radius_resident(index: QuakeIndex, k: int,
                              n_sample: int = 8) -> float:
    """Deterministic, query-independent APS radius calibration: sample
    resident vectors (first row of up to ``n_sample`` evenly spaced
    non-empty partitions) as pseudo-queries and run the batched
    calibration search.  Unlike the planner's default batch-sample
    calibration, the result depends only on index state — so per-query
    plans (and therefore served results) are invariant under how the
    serving queue happened to coalesce the batch that triggered the
    calibration."""
    lvl0 = index.levels[0]
    sizes = lvl0.sizes()
    nz = np.nonzero(sizes)[0]
    if len(nz) == 0:
        return np.inf
    pick = nz[np.unique(np.linspace(0, len(nz) - 1,
                                    min(n_sample, len(nz))).astype(int))]
    qs = np.stack([lvl0.vectors[int(j)][0] for j in pick]).astype(np.float32)
    # resident vectors match themselves at distance 0 (rank 1), which
    # would bias the k-th distance low and make the planner underprobe —
    # calibrate past rank k+1 (the unbiased k-th for a query *near* but
    # not identical to a stored vector), with extra slack ranks: a
    # modestly inflated radius only makes the planner scan more, never
    # less, which is the recall-safe side of the approximation
    return mq._calibrate_kth_batched(index, qs, k + 1 + max(1, k // 2),
                                     mq._aps_candidate_budget(index))


# ---------------------------------------------------------------------------
# Query-aware result cache (QVCache-style, journal-invalidated)
# ---------------------------------------------------------------------------

class ResultCache:
    """LRU top-k result cache keyed by normalized-query code.

    ``bits > 0`` keys queries by the sign pattern of ``bits`` fixed random
    projections (nearby queries collide, so Zipf-popular queries with
    per-request jitter still hit); ``bits == 0`` keys by exact query
    bytes.  A key collision alone never serves a result: the hit must
    also be within ``tol`` L2 distance of the stored exemplar query
    (``tol == 0`` = identical queries only), and the served result is
    the exemplar's — approximate for ``tol > 0`` in exactly the way ANN
    serving already is.

    Every entry remembers the **planned probe footprint** of the search
    that produced it.  Invalidation is driven by the index's mutation
    journal: ``invalidate_partitions(dirty)`` drops every entry whose
    footprint intersects the dirty set (content changes outside an
    entry's footprint cannot change what that entry's plan would have
    scanned — inserts and deletes move no centroids, so the probe set
    over an unchanged directory is unchanged), and any structural delta
    clears the cache (partition ids are re-assigned by split/merge
    swap-remove, so footprints stop meaning anything).

    Thread safety: every public method takes ``_lock``
    (``ResultCache._lock`` in the declared ``LOCK_ORDER``).  Because a
    search runs *outside* any cache lock, a ``put`` can race an
    invalidation that happened after the search was admitted — every
    invalidation bumps a **generation counter**, admission captures it,
    and ``put(..., gen=...)`` drops the entry (counted in
    ``stale_puts``) when the generations no longer match.  Without this
    a drained result would re-insert an entry the journal already
    declared stale (the QK201 exemplar race).
    """

    def __init__(self, max_entries: int = 4096, bits: int = 0,
                 tol: float = 0.0, seed: int = 0):
        self._lock = TrackedLock("ResultCache._lock")
        self.max_entries = max_entries
        self.bits = bits
        self.tol = float(tol)
        self._seed = seed
        self._proj: Optional[np.ndarray] = None
        self._store: "OrderedDict[int, dict]" = OrderedDict()  # eid -> entry
        self._by_key: Dict[bytes, List[int]] = {}
        self._by_part: Dict[int, set] = {}
        self._next_eid = 0
        self._gen = 0
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.stale_puts = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    @property
    def generation(self) -> int:
        """Invalidation generation — capture at admission, hand back to
        ``put``; a mismatch means an invalidation happened in between."""
        with self._lock:
            return self._gen

    def _key(self, q: np.ndarray) -> bytes:
        if self.bits <= 0:
            return q.tobytes()
        if self._proj is None or self._proj.shape[1] != q.shape[0]:
            rng = np.random.default_rng(self._seed)
            self._proj = rng.normal(
                size=(self.bits, q.shape[0])).astype(np.float32)
        return np.packbits(self._proj @ q >= 0.0).tobytes()

    def get(self, q: np.ndarray, k: int) -> Optional[dict]:
        q = np.ascontiguousarray(q, dtype=np.float32)
        with self._lock:
            note_guarded(self, "_store")
            best, best_d = None, np.inf
            for eid in self._by_key.get(self._key(q), ()):
                e = self._store[eid]
                if e["k"] != k:
                    continue
                d = float(np.linalg.norm(q - e["q"]))
                if d <= self.tol and d < best_d:
                    best, best_d = e, d
            if best is None:
                self.misses += 1
                return None
            self._store.move_to_end(best["eid"])
            self.hits += 1
            # shallow copy: the caller reads fields after the lock drops,
            # and the entry itself may be evicted meanwhile
            return dict(best)

    def put(self, q: np.ndarray, k: int, ids: np.ndarray, dists: np.ndarray,
            footprint: np.ndarray, nprobe: int = 0,
            recall_estimate: float = np.nan,
            gen: Optional[int] = None) -> None:
        with self._lock:
            note_guarded(self, "_store")
            if self.max_entries <= 0:
                return
            if gen is not None and gen != self._gen:
                # an invalidation ran after this result was admitted:
                # inserting it would resurrect journal-stale state
                self.stale_puts += 1
                return
            q = np.ascontiguousarray(q, dtype=np.float32)
            key = self._key(q)
            eid = self._next_eid
            self._next_eid += 1
            fp = np.unique(np.asarray(footprint, dtype=np.int64))
            self._store[eid] = {
                "eid": eid, "key": key, "k": k, "q": q.copy(),
                "ids": np.asarray(ids).copy(),
                "dists": np.asarray(dists).copy(),
                "footprint": fp, "nprobe": int(nprobe),
                "recall_estimate": float(recall_estimate)}
            self._by_key.setdefault(key, []).append(eid)
            for p in fp:
                self._by_part.setdefault(int(p), set()).add(eid)
            while len(self._store) > self.max_entries:
                old_eid, old_entry = self._store.popitem(last=False)  # LRU
                self._unlink(old_eid, old_entry)

    def _unlink(self, eid: int, entry: dict) -> None:
        eids = self._by_key.get(entry["key"], [])
        if eid in eids:
            eids.remove(eid)
            if not eids:
                del self._by_key[entry["key"]]
        for p in entry["footprint"]:
            s = self._by_part.get(int(p))
            if s is not None:
                s.discard(eid)
                if not s:
                    del self._by_part[int(p)]

    def _remove(self, eid: int) -> None:
        entry = self._store.pop(eid, None)
        if entry is not None:
            self._unlink(eid, entry)

    def invalidate_partitions(self, dirty: Iterable[int]) -> int:
        """Drop every entry whose planned footprint touches ``dirty``."""
        with self._lock:
            note_guarded(self, "_store")
            doomed: set = set()
            for p in dirty:
                doomed |= self._by_part.get(int(p), set())
            for eid in doomed:
                self._remove(eid)
            self.invalidated += len(doomed)
            self._gen += 1          # in-flight puts are now suspect
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            note_guarded(self, "_store")
            self.invalidated += len(self._store)
            self._store.clear()
            self._by_key.clear()
            self._by_part.clear()
            self._gen += 1          # in-flight puts are now suspect

    def counters(self) -> dict:
        """Lock-consistent copy of the cache telemetry."""
        with self._lock:
            return {"entries": len(self._store), "hits": self.hits,
                    "misses": self.misses,
                    "invalidated": self.invalidated,
                    "stale_puts": self.stale_puts,
                    "generation": self._gen}


# ---------------------------------------------------------------------------
# Drift-triggered maintenance scheduling
# ---------------------------------------------------------------------------

@dataclass
class MaintenanceTriggers:
    """When the serving loop should pay for a maintenance pass.

    ``min_ops`` rate-limits passes; beyond it a pass runs when any drift
    signal fires: the journal's folded dirty mass since the last pass
    (``dirty_frac`` of the partition directory — the Incremental-IVF
    decoupling of maintenance cadence from the op stream), the
    cost-model estimate moving by ``cost_drift`` relative to the cost at
    the last pass (Eq. 2 over current sizes and served access
    frequencies), or the served access histogram shifting by
    ``access_shift`` total-variation distance (read-skew drift: the same
    partitions, differently hot).  ``max_ops`` forces a pass regardless
    — the backstop that bounds how stale statistics can get."""
    min_ops: int = 4
    dirty_frac: float = 0.25
    cost_drift: float = 0.15
    access_shift: float = 0.6
    max_ops: Optional[int] = 64


class MaintenanceScheduler:
    """Replaces run-after-every-op with drift triggers over the journal,
    the cost model, and the served access histogram.

    Thread safety: public methods take ``_lock``
    (``MaintenanceScheduler._lock``, innermost in the declared
    ``LOCK_ORDER``) — the runtime's engine lock already serializes
    maintenance *work*; this lock only keeps the trigger counters and
    history coherent for concurrent ``stats()`` readers."""

    def __init__(self, maintainer: Maintainer,
                 triggers: Optional[MaintenanceTriggers] = None):
        self._lock = TrackedLock("MaintenanceScheduler._lock")
        self.maintainer = maintainer
        self.index = maintainer.index
        self.triggers = triggers or MaintenanceTriggers()
        self.ops_since = 0
        self.history: List[dict] = []
        self.pass_s: List[float] = []    # seconds of each pass, in order
        self._rebaseline()

    def _freq_vector(self) -> np.ndarray:
        lvl0 = self.index.levels[0]
        return lvl0.stats.access_freq(lvl0.num_partitions,
                                      self.index.config.default_access_freq)

    def _rebaseline(self) -> None:
        with self._lock:
            self._last_version = self.index.version
            self._last_cost = self.maintainer.total_cost()
            self._last_freqs = self._freq_vector().copy()
            self.ops_since = 0

    def note_op(self, n: int = 1) -> None:
        with self._lock:
            self.ops_since += n

    def due(self) -> Optional[str]:
        """Trigger that fired, or None.  Cheap: one journal fold, one
        O(P) cost evaluation, one O(P) histogram distance."""
        with self._lock:
            t = self.triggers
            if self.ops_since < t.min_ops:
                return None
            if t.max_ops is not None and self.ops_since >= t.max_ops:
                return "op_budget"
            delta = self.index.journal.delta_since(self._last_version)
            if delta is None:
                return "journal_trimmed"
            if delta.structural:
                return "structural"
            p = max(self.index.num_partitions, 1)
            if len(delta.dirty) >= t.dirty_frac * p:
                return "dirty_mass"
            cost = self.maintainer.total_cost()
            if abs(cost - self._last_cost) >= t.cost_drift * max(
                    self._last_cost, 1e-9):
                return "cost_drift"
            f, g = self._freq_vector(), self._last_freqs
            m = min(len(f), len(g))
            fs, gs = float(f[:m].sum()), float(g[:m].sum())
            if m and fs > 0 and gs > 0:
                shift = 0.5 * float(np.abs(f[:m] / fs - g[:m] / gs).sum())
                if shift >= t.access_shift:
                    return "access_shift"
            return None

    def run_if_due(self, force: bool = False) -> Optional[MaintenanceReport]:
        reason = "forced" if force else self.due()
        if reason is None:
            return None
        # the actual pass runs outside _lock: the runtime's engine lock
        # serializes maintenance work, and holding the innermost lock
        # across index mutation would pin every stats() reader behind it
        t0 = time.perf_counter()
        rep = self.maintainer.run()
        dt = time.perf_counter() - t0
        with self._lock:
            self.pass_s.append(dt)
            self.history.append({
                "reason": reason, "ops_since": self.ops_since,
                "splits": rep.splits, "merges": rep.merges,
                "cost_before": round(rep.cost_before, 1),
                "cost_after": round(rep.cost_after, 1)})
        self._rebaseline()
        return rep

    def snapshot(self) -> dict:
        """Lock-consistent deep copy of the trigger telemetry."""
        with self._lock:
            return {"runs": len(self.history),
                    "reasons": [h["reason"] for h in self.history],
                    "history": [dict(h) for h in self.history],
                    "pass_s": list(self.pass_s),
                    "ops_since": self.ops_since}


# ---------------------------------------------------------------------------
# Host scan backend (CPU fast path for the riding rounds)
# ---------------------------------------------------------------------------

def host_scan_round(index: QuakeIndex, q: np.ndarray, seq: np.ndarray,
                    take: np.ndarray, kept: np.ndarray, k_keep: int,
                    q_norm_sq: Optional[np.ndarray] = None):
    """One riding round scanned on host: for every union partition, one
    BLAS GEMM over exactly the queries that take it and exactly the rows
    it holds — the ragged-buffer mirror of the packed device scan, with
    no padded-slot compute (the index docstring's rationale for the
    ``numpy`` backend: per-partition scans are tiny on CPU and device
    dispatch would dominate).  Serving write barriers freeze the index
    within a scheduler epoch, so scanning the live buffers is coherent
    with the plan.  The partition is still streamed/computed once for
    all riders — the amortization the round union exists for.

    Returns (dists (B, k_keep), ids (B, k_keep) **external** ids, stats)
    with MASK_DIST / -1 padding — same conventions as the device scan
    except ids are already external (no flat-index indirection).
    """
    lvl0 = index.levels[0]
    b = q.shape[0]
    metric = index.config.metric
    if metric == "l2" and q_norm_sq is None:
        q_norm_sq = np.sum(q.astype(np.float64) ** 2, axis=1)
    cand_d: List[List[np.ndarray]] = [[] for _ in range(b)]
    cand_i: List[List[np.ndarray]] = [[] for _ in range(b)]
    vectors = comparisons = 0
    # one pass over the taken cells groups query rows by partition —
    # O(nnz log nnz) instead of a full (B, M) mask scan per partition
    rr, cc = np.nonzero(take)
    if len(rr):
        parts = seq[rr, cc]
        order = np.argsort(parts, kind="stable")
        rr, parts = rr[order], parts[order]
        bounds = np.nonzero(np.diff(parts))[0] + 1
        starts = np.concatenate([np.zeros(1, dtype=np.int64), bounds])
        groups = dict(zip(parts[starts].tolist(), np.split(rr, bounds)))
    else:
        groups = {}
    for j in kept:
        j = int(j)
        rows = groups.get(j, ())
        x = lvl0.vectors[j]
        s = x.shape[0]
        vectors += s
        if s == 0 or len(rows) == 0:
            continue
        comparisons += s * len(rows)
        qj = q[rows]
        if metric == "l2":
            d = (lvl0.sqnorms[j][None, :].astype(np.float64)
                 - 2.0 * (qj @ x.T) + q_norm_sq[rows][:, None])
        else:
            d = -(qj @ x.T).astype(np.float64)
        kk = min(k_keep, s)
        if kk < s:
            part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            dd = np.take_along_axis(d, part, axis=1)
            ii = lvl0.ids[j][part]
        else:
            dd, ii = d, np.broadcast_to(lvl0.ids[j], d.shape)
        for r, row in enumerate(rows):
            cand_d[row].append(dd[r])
            cand_i[row].append(ii[r])
    out_d = np.full((b, k_keep), MASK_DIST, dtype=np.float64)
    out_i = np.full((b, k_keep), -1, dtype=np.int64)
    for row in range(b):
        if not cand_d[row]:
            continue
        d = np.concatenate(cand_d[row])
        i = np.concatenate(cand_i[row])
        kk = min(k_keep, len(d))
        sel = np.argpartition(d, kk - 1)[:kk] if kk < len(d) \
            else np.arange(len(d))
        out_d[row, :kk] = d[sel]
        out_i[row, :kk] = i[sel]
    order = np.argsort(out_d, axis=1, kind="stable")
    out_d = np.take_along_axis(out_d, order, axis=1)
    out_i = np.take_along_axis(out_i, order, axis=1)
    st = {"partitions": int(len(kept)), "vectors": int(vectors),
          "comparisons": int(comparisons)}
    return out_d, out_i, st


# ---------------------------------------------------------------------------
# Cross-batch riding round scheduler
# ---------------------------------------------------------------------------

@dataclass
class _Pending:
    """One in-flight query's round state (the per-row decomposition of
    ``run_round_loop``'s batch arrays, so membership can change)."""
    qid: int
    q: np.ndarray              # (d,)
    q_norm_sq: float
    seq: np.ndarray            # (M,) scan-ordered candidate partitions
    count: int                 # planned probe budget (fixed-plan cells)
    geo: np.ndarray            # (M,) seq-aligned geometry distances
    cc: np.ndarray             # (M,) seq-aligned center-center distances
    wins: List[Tuple[int, int]]
    win_ptr: int
    scanned: np.ndarray        # (M,) bool — cells consumed so far
    r_est: float
    td: np.ndarray             # (k_keep,) running top distances
    ti: np.ndarray             # (k_keep,) running top flat indices
    t_submit: float
    batch: int                 # admission group (riding accounting)
    rounds: int = 0            # rounds this query took cells in
    deadline: Optional[float] = None  # absolute clock value the latency
                               # budget expires at (None = no budget)


class RoundScheduler:
    """Cross-batch generalization of ``run_round_loop``: drives probe
    rounds over a query population that *changes between rounds*.

    Queries join via :meth:`admit` (planned against the executor's
    current snapshot); each :meth:`step` takes every in-flight query's
    next probe window, forms one shared partition union, lets every
    query additionally consume all of its not-yet-scanned probes landing
    in that union (union riding, now across admission groups), scans the
    union once (``BatchedSearchExecutor.scan_probe_round``), folds the
    result into per-query running top-k state, and retires queries whose
    plan is exhausted — or, with ``early_exit``, whose refined APS
    estimate cleared the target.

    Invariants:
      * footprint: partitions streamed across all rounds ⊆ the union of
        the admitted batches' fixed plans (riding consumes planned cells
        early; it never adds partitions a plan didn't contain);
      * co-admitted amortization: while no new group is admitted
        mid-flight, a partition block streams at most once — exactly
        ``run_round_loop``'s per-batch guarantee, extended to every
        batch coalesced into the group.

    With ``early_exit=False`` every query consumes exactly its fixed
    plan, so results are independent of how admission interleaved with
    rounds — the runtime's coalescing-determinism contract.
    """

    def __init__(self, executor: "mq.BatchedSearchExecutor", k: int,
                 target: float, rounds: Optional[int] = None,
                 early_exit: bool = False, b_bucket: int = 16,
                 record_stats: bool = True, scan_backend: str = "auto",
                 clock: Optional[Callable[[], float]] = None,
                 faults: Optional[FaultInjector] = None,
                 scan_retries: int = 2, scan_backoff_s: float = 0.001,
                 scan_backoff_max_s: float = 0.05, obs=None):
        self._lock = TrackedLock("RoundScheduler._lock")
        self._clock = clock or time.perf_counter
        # obs.Observability bundle or None; its locks rank after
        # RoundScheduler._lock in sanitize.LOCK_ORDER, so recording from
        # inside a locked step can never invert the order
        self.obs = obs
        self.ex = executor
        self.index = executor.index
        self.k = k
        self.target = target
        self.probe_frac: Optional[float] = None  # governor probe-budget cap
        self.round_budget = rounds
        self.early_exit = early_exit
        self.b_bucket = max(b_bucket, 1)
        self.record_stats = record_stats
        self.faults = faults
        self.scan_retries = max(int(scan_retries), 0)
        self.scan_backoff_s = float(scan_backoff_s)
        self.scan_backoff_max_s = float(scan_backoff_max_s)
        self._last_scan_error: Optional[BaseException] = None
        if scan_backend == "auto":
            scan_backend = ("device" if executor.device.type == "cuda"
                            else "host")
        if scan_backend not in ("host", "device"):
            raise ValueError(f"scan_backend must be host/device/auto, "
                             f"got {scan_backend!r}")
        self.scan_backend = scan_backend
        self.active: List[_Pending] = []
        self.done: List[tuple] = []     # (qid, QueryResult, q, footprint)
        self._epoch_key = None
        self._snap = None
        self._m: Optional[int] = None
        self._k_keep = k
        self._rerank = False
        self._batches = 0
        # riding / invariant telemetry
        self.rounds_run = 0
        self.round_streams: List[np.ndarray] = []   # kept ids per round
        self.plan_footprints: List[np.ndarray] = [] # per admitted batch
        self.partitions_streamed = 0
        self.vectors_streamed = 0
        self.comparisons = 0
        # failure / degradation telemetry
        self.partials = 0           # budget-expired retirements
        self.failures = 0           # FAILED retirements
        self.failed_batches = 0     # rounds whose scan exhausted retries
        self.scan_faults = 0        # scan attempts that raised
        self.scan_retries_used = 0  # backoff retries taken
        # deferred hot-path observability: per-round samples accumulate
        # here as plain appends under the already-held scheduler lock
        # and drain through ``flush_obs`` in ONE registry update + ONE
        # tracer emit per collect pass — even a batched TrackedLock
        # acquisition per round is measurable against a ~100us query
        # (measurable against a ~100us query)
        self._obs_walls: List[float] = []
        self._obs_parts = 0
        self._obs_vecs = 0
        self._obs_rounds: List[dict] = []
        self._obs_flushes: List[dict] = []
        self._cal_tick = 0

    def set_degradation(self, target: float,
                        probe_frac: Optional[float]) -> None:
        """Governor hook: effective recall target and per-query probe-
        budget fraction for *subsequent* admissions (``None`` = no cap).
        In-flight queries keep the plans they were admitted with."""
        with self._lock:
            self.target = float(target)
            self.probe_frac = probe_frac

    # -- admission -----------------------------------------------------

    def admit(self, queries: np.ndarray, qids: Sequence[int],
              t_submit: Optional[Sequence[float]] = None,
              deadlines: Optional[Sequence[Optional[float]]] = None) -> None:
        """Plan one coalesced batch and add its queries to the in-flight
        population.  All admissions between drains must see the same
        snapshot fingerprint (writes barrier through the runtime).
        ``deadlines`` are absolute clock values (same clock as the
        scheduler's) at which each query's latency budget expires —
        expired queries retire ``PARTIAL`` at the end of the round that
        noticed (None entries have no budget)."""
        with self._lock:
            note_guarded(self, "active")
            q = np.ascontiguousarray(queries, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
            b = q.shape[0]
            if b == 0:
                return
            if self.scan_backend == "host":
                # no device snapshot: rounds scan the live ragged
                # buffers, which the runtime's write barriers freeze
                # within an epoch
                self.ex.planner_cache.ensure_fresh()
                snap = None
            else:
                if not self.active:
                    # a new epoch: let a rebuild free the old snapshot's
                    # device memory before it allocates the new one
                    self._snap = None
                snap = self.ex.snapshot()
            fp = self.ex._fingerprint()
            if self.active and fp != self._epoch_key:
                raise RuntimeError(
                    "snapshot changed under in-flight queries; drain() "
                    "before mutating the index (the runtime's write "
                    "barrier does this)")
            self._epoch_key = fp
            self._snap = snap
            self._rerank = (snap is not None and snap.scales is not None
                            and self.ex.int8_rerank
                            and self.ex._mirror is not None)
            self._k_keep = 2 * self.k if self._rerank else self.k
            rplan = mq.plan_rounds(self.index, q, self.k, self.target,
                                   planner=self.ex.planner,
                                   cache=self.ex.planner_cache,
                                   cent_norms=self.ex._cent_norms)
            m = rplan.seq.shape[1]
            if self._m is None or not self.active:
                self._m = m
            assert m == self._m, (m, self._m)
            now = self._clock()
            ts = t_submit if t_submit is not None else [now] * b
            dls = deadlines if deadlines is not None else [None] * b
            qn = np.sum(q.astype(np.float64) ** 2, axis=1)
            batch_id = self._batches
            self._batches += 1
            if self.obs is not None:
                # flush metadata for span synthesis: spans reference it
                # through their batch id (QueryTracer.note_flushes)
                # instead of paying a per-query flush event here
                self._obs_flushes.append(
                    {"batch": batch_id, "t": now, "n": b})
            eff_counts = []
            for i in range(b):
                count = int(rplan.counts[i])
                if self.probe_frac is not None:
                    # governor degradation: truncate the plan to a
                    # fraction of its probe budget (footprint bound —
                    # the serving-layer union_cap analog)
                    count = max(1, int(np.ceil(count * self.probe_frac)))
                eff_counts.append(count)
                self.active.append(_Pending(
                    qid=int(qids[i]), q=q[i], q_norm_sq=float(qn[i]),
                    seq=rplan.seq[i], count=count,
                    geo=rplan.geo[i], cc=rplan.cc[i],
                    wins=mq._round_windows(count, self.round_budget),
                    win_ptr=0, scanned=np.zeros(m, dtype=bool),
                    r_est=float(rplan.recall_est[i]),
                    td=np.full(self._k_keep, MASK_DIST, dtype=np.float64),
                    ti=np.full(self._k_keep, -1, dtype=np.int64),
                    t_submit=float(ts[i]), batch=batch_id,
                    deadline=None if dls[i] is None else float(dls[i])))
            self.plan_footprints.append(
                np.unique(np.concatenate(
                    [rplan.seq[i][:eff_counts[i]] for i in range(b)])))
            if self.record_stats:
                lvl0 = self.index.levels[0]
                lvl0.stats.ensure(lvl0.num_partitions)
                lvl0.stats.record_batch(np.zeros(0, np.int64),
                                        np.zeros(0), b)

    # -- rounds --------------------------------------------------------

    def step(self) -> bool:
        """Run one shared probe round.  Returns False once nothing is in
        flight (all queries retired)."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        note_guarded(self, "active")
        rows = self.active
        if not rows:
            return False
        b = len(rows)
        m = self._m
        seq_mat = np.stack([pq.seq for pq in rows])
        scanned = np.stack([pq.scanned for pq in rows])
        counts = np.asarray([pq.count for pq in rows])
        cols = np.arange(m)[None, :]
        within = cols < counts[:, None]
        avail = within & ~scanned

        base = np.zeros((b, m), dtype=bool)
        for i, pq in enumerate(rows):
            # advance past windows that riding already consumed
            while pq.win_ptr < len(pq.wins):
                c0, c1 = pq.wins[pq.win_ptr]
                if avail[i, c0:c1].any():
                    base[i, c0:c1] = avail[i, c0:c1]
                    break
                pq.win_ptr += 1
        if not base.any():
            self._retire(rows, np.ones(b, dtype=bool), scanned, within)
            return bool(self.active)

        kept = np.unique(seq_mat[base])
        p = self.index.levels[0].num_partitions
        in_union = np.zeros(max(int(seq_mat.max()) + 1, p), dtype=bool)
        in_union[kept] = True
        take = avail & in_union[seq_mat]
        scanned |= take

        q_mat = np.stack([pq.q for pq in rows])
        if self.faults is not None:
            self.faults.stall("slow_round")   # injected straggler round
        t_scan = self._clock()
        scan = self._scan_with_retry(q_mat, seq_mat, take, kept, rows)
        if scan is None:
            # retries exhausted: fail the affected in-flight batch —
            # every query gets a terminal FAILED result and the runtime
            # (queue, ticker, future admissions) stays alive
            self._fail_inflight(rows, scanned, within)
            return bool(self.active)
        d, flat, st = scan

        # fold into per-query running top-k (host side: rows churn)
        td = np.stack([pq.td for pq in rows])
        ti = np.stack([pq.ti for pq in rows])
        cat_d = np.concatenate([td, d], axis=1)
        cat_i = np.concatenate([ti, flat], axis=1)
        order = np.argsort(cat_d, axis=1, kind="stable")[:, :self._k_keep]
        td = np.take_along_axis(cat_d, order, axis=1)
        ti = np.take_along_axis(cat_i, order, axis=1)

        took = take.any(axis=1)
        takers = [] if self.obs is not None else None
        for i, pq in enumerate(rows):
            pq.scanned = scanned[i]
            pq.td = td[i]
            pq.ti = ti[i]
            pq.rounds += int(took[i])
            if takers is not None and took[i]:
                takers.append(pq.qid)

        self.rounds_run += 1
        self.round_streams.append(kept)
        self.partitions_streamed += st["partitions"]
        self.vectors_streamed += st["vectors"]
        self.comparisons += st["comparisons"]
        if self.obs is not None:
            t_now = self._clock()
            dt_scan = t_now - t_scan
            self._obs_walls.append(dt_scan)
            self._obs_parts += int(st["partitions"])
            self._obs_vecs += int(st["vectors"])
            # predicted-vs-observed scan cost, sampled every 4th round
            # (first round always): ``predict_scan_ns`` over the folded
            # sizes is a numpy pass per call, and roughly-one-sample-
            # per-flush keeps the rolling error just as live at a
            # quarter of the cost
            self._cal_tick += 1
            if self._cal_tick % 4 == 1:
                self.obs.calibration.record_scan(
                    self.index.levels[0].sizes_of(kept), dt_scan)
            # one metadata record per round — the taker qids are how
            # spans recover per-round scan events at read time
            # (QueryTracer.note_rounds); no per-query work here
            self._obs_rounds.append({
                "t": t_now, "round": self.rounds_run,
                "partitions": int(st["partitions"]),
                "vectors": int(st["vectors"]),
                "wall_s": dt_scan, "takers": takers})
        if self.record_stats:
            parts, cnts = np.unique(seq_mat[take], return_counts=True)
            lvl0 = self.index.levels[0]
            lvl0.stats.ensure(lvl0.num_partitions)
            lvl0.stats.record_batch(parts, cnts, 0)

        finished = ~(within & ~scanned).any(axis=1)
        statuses = np.full(b, STATUS_OK, dtype=object)
        now = self._clock()
        expired = np.asarray([pq.deadline is not None and now >= pq.deadline
                              for pq in rows])
        if self.early_exit or bool((expired & ~finished).any()):
            # refined APS estimate from the *running* k-th distance —
            # the early-exit retirement test, and what a budget-expired
            # query's PARTIAL result reports as the recall it earned
            kth = td[:, self.k - 1]
            full = kth < MASK_DIST
            if self.index.config.metric == "l2":
                rho_sq = aps_mod.rho_sq_batch(kth, metric="l2")
            else:
                qn = np.asarray([pq.q_norm_sq for pq in rows])
                rho_sq = aps_mod.rho_sq_batch(
                    kth, metric="ip", q_norm_sq=qn,
                    max_norm_sq=self.index._max_norm_sq)
            rho_sq = np.where(full, rho_sq, np.inf)
            geo_mat = np.stack([pq.geo for pq in rows])
            cc_mat = np.stack([pq.cc for pq in rows])
            valid = np.ones((b, m), dtype=bool)
            valid[:, 0] = False
            p0, probs = aps_mod.estimate_probs_batch(
                geo_mat[:, 0], geo_mat, cc_mat, rho_sq,
                self.index._beta_table, valid)
            r = p0 + np.where(scanned & valid, probs, 0.0).sum(axis=1)
            if self.early_exit:
                for i, pq in enumerate(rows):
                    if full[i]:
                        pq.r_est = float(r[i])
                finished |= full & (r >= self.target)
            partial = expired & ~finished
            if partial.any():
                for i in np.nonzero(partial)[0]:
                    # finite by construction: the refined estimate over
                    # what was actually scanned, or 0.0 when the top-k
                    # never filled (the honest lower bound) — never the
                    # full-plan estimate the query didn't earn
                    rows[i].r_est = float(r[i]) if full[i] else 0.0
                statuses[partial] = STATUS_PARTIAL
                self.partials += int(partial.sum())
                finished |= partial
        self._retire(rows, finished, scanned, within, statuses)
        return True

    # -- fault handling ------------------------------------------------

    def _scan_once(self, q_mat: np.ndarray, seq_mat: np.ndarray,
                   take: np.ndarray, kept: np.ndarray,
                   rows: List[_Pending]):
        b, m = take.shape
        if self.scan_backend == "host":
            return host_scan_round(
                self.index, q_mat, seq_mat, take, kept, self._k_keep,
                q_norm_sq=np.asarray([pq.q_norm_sq for pq in rows]))
        # pad the active rows on a geometric ladder (b_bucket * 2^i)
        # so the scan sees O(log B) distinct (B, M) shapes as the
        # in-flight population grows/shrinks; pad rows carry take=False
        # (inert under the scan mask)
        b_pad = self.b_bucket
        while b_pad < b:
            b_pad *= 2
        q_pad = q_mat
        if b_pad > b:
            q_pad = np.concatenate(
                [q_mat,
                 np.zeros((b_pad - b, q_mat.shape[1]), np.float32)])
            seq_pad = np.concatenate(
                [seq_mat, np.zeros((b_pad - b, m), seq_mat.dtype)])
            take_pad = np.concatenate(
                [take, np.zeros((b_pad - b, m), bool)])
        else:
            seq_pad, take_pad = seq_mat, take
        dev = self.ex.device
        with allow_sync("explicit upload of the round's queries and plan"):
            q_dev = torch.as_tensor(q_pad, device=dev)
            seq_dev = torch.as_tensor(seq_pad.astype(np.int32), device=dev)
        d, flat, st = self.ex.scan_probe_round(
            q_dev, seq_dev, take_pad, kept, self._k_keep, snap=self._snap,
            u_pow2=True, seq_host=seq_pad)
        # the scheduler's running top-k folds on host because the row
        # set churns every round (admissions/retirements) — one pull
        # per round over the active rows
        with allow_sync("per-round fold: host top-k over a churning row set"):
            # quakecheck: allow-sync(per-round fold: host top-k over a churning row set)
            d = d[:b].double().cpu().numpy()
            flat = flat[:b].long().cpu().numpy()  # quakecheck: allow-sync(per-round fold)
        check_finite("the round scan's distances", d)
        return d, flat, st

    def _scan_with_retry(self, q_mat: np.ndarray, seq_mat: np.ndarray,
                         take: np.ndarray, kept: np.ndarray,
                         rows: List[_Pending]):
        """One round scan with capped exponential backoff.  Returns the
        scan triple, or None once ``scan_retries`` retries are exhausted
        (the caller fails the in-flight batch).  A scan exception —
        injected or real — never propagates out of the scheduler."""
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.check("scan")
                return self._scan_once(q_mat, seq_mat, take, kept, rows)
            except Exception as e:
                self.scan_faults += 1
                self._last_scan_error = e
                if attempt >= self.scan_retries:
                    return None
                self.scan_retries_used += 1
                self._sleep(min(self.scan_backoff_s * (2.0 ** attempt),
                                self.scan_backoff_max_s))
                attempt += 1

    def _sleep(self, delay: float) -> None:
        if delay <= 0:
            return
        fn = self.faults.sleep_fn if self.faults is not None else time.sleep
        fn(delay)

    def _fail_inflight(self, rows: List[_Pending], scanned: np.ndarray,
                       within: np.ndarray) -> None:
        """Retire every in-flight query with a terminal FAILED result
        (ids -1 / dists inf) carrying the scan error.  Queued-but-not-
        admitted queries are unaffected — only the batch whose scan
        exhausted its retries fails."""
        err = repr(self._last_scan_error)
        self.failed_batches += 1
        now = self._clock()
        for i, pq in enumerate(rows):
            res = QueryResult(
                ids=np.full(self.k, -1, dtype=np.int64),
                dists=np.full(self.k, np.inf, dtype=np.float64),
                nprobe=int((scanned[i] & within[i]).sum()),
                recall_estimate=0.0, rounds=pq.rounds,
                latency_s=now - pq.t_submit,
                status=STATUS_FAILED, error=err,
                t_submit=pq.t_submit, batch=pq.batch)
            self.failures += 1
            self.done.append((pq.qid, res, None, None))
        self.active = []
        logger.warning("round scan failed after %d retries (%s): "
                       "failed %d in-flight queries",
                       self.scan_retries, err, len(rows))

    def _retire(self, rows: List[_Pending], finished: np.ndarray,
                scanned: np.ndarray, within: np.ndarray,
                statuses: Optional[np.ndarray] = None) -> None:
        idxs = np.nonzero(finished)[0]
        if len(idxs):
            now = self._clock()
            td = np.stack([rows[i].td for i in idxs])
            ti = np.stack([rows[i].ti for i in idxs])
            if self._rerank:
                qd = np.stack([rows[i].q for i in idxs])
                dd, flat = self.ex._rerank_exact(qd, ti, self.k)
            else:
                dd, flat = td[:, :self.k], ti[:, :self.k]
            if self.scan_backend == "host":
                ids = flat        # host rounds carry external ids directly
            else:
                ids = np.where(flat >= 0,
                               self.ex._flat_ids[np.maximum(flat, 0)], -1)
            dd = np.where(dd >= MASK_DIST, np.inf, dd)
            for row, i in enumerate(idxs):
                pq = rows[i]
                status = (STATUS_OK if statuses is None
                          else str(statuses[i]))
                res = QueryResult(
                    ids=ids[row].astype(np.int64), dists=dd[row],
                    nprobe=int((scanned[i] & within[i]).sum()),
                    recall_estimate=pq.r_est, rounds=pq.rounds,
                    latency_s=now - pq.t_submit,
                    status=status,
                    t_submit=pq.t_submit, batch=pq.batch)
                # PARTIAL results never enter the cache (the caller
                # checks status): the footprint is still the plan's, so
                # pass it along for telemetry, not for caching
                self.done.append((pq.qid, res, pq.q,
                                  pq.seq[:pq.count]))
        self.active = [pq for i, pq in enumerate(rows) if not finished[i]]

    def take_done(self) -> List[tuple]:
        """Hand off and clear the finished-query list — the write-barrier
        API for consuming ``done`` (callers must not mutate the list in
        place; ownership of the returned batch transfers to the caller)."""
        with self._lock:
            note_guarded(self, "done")
            out = self.done
            self.done = []
            return out

    def drain(self) -> None:
        while self.step():
            pass

    def flush_obs(self) -> None:
        """Drain the deferred round/flush observability (accumulated by
        the locked step and admit as plain appends) into ONE batched
        registry update and the tracer's metadata streams.  The runtime
        calls this on every collect pass — before terminal records are
        closed, so span synthesis has the metadata its spans reference
        — and from ``metrics_snapshot`` so snapshots never lag
        in-flight rounds."""
        if self.obs is None:
            return
        with self._lock:
            note_guarded(self, "_obs_rounds")
            walls, self._obs_walls = self._obs_walls, []
            rounds, self._obs_rounds = self._obs_rounds, []
            flushes, self._obs_flushes = self._obs_flushes, []
            parts, vecs = self._obs_parts, self._obs_vecs
            self._obs_parts = 0
            self._obs_vecs = 0
        if walls:
            self.obs.metrics.update(
                counters={"scheduler.rounds": len(walls),
                          "scheduler.partitions_streamed": parts,
                          "scheduler.vectors_streamed": vecs},
                observations={"scheduler.round_wall_s": walls})
        if flushes:
            self.obs.tracer.note_flushes(flushes)
        if rounds:
            self.obs.tracer.note_rounds(rounds)

    def has_active(self) -> bool:
        with self._lock:
            return bool(self.active)

    def release_snapshot(self) -> None:
        """Drop the epoch's snapshot reference while nothing is in
        flight, so the executor can free its device memory."""
        with self._lock:
            if not self.active:
                self._snap = None

    def epoch_key(self):
        with self._lock:
            return self._epoch_key

    def epoch_footprint(self) -> np.ndarray:
        """Distinct partitions streamed so far (invariant telemetry)."""
        with self._lock:
            if not self.round_streams:
                return np.zeros(0, dtype=np.int64)
            return np.unique(np.concatenate(self.round_streams))

    def snapshot(self) -> dict:
        """Lock-consistent copy of the riding telemetry (what
        ``ServingRuntime.stats()`` reports)."""
        with self._lock:
            return {
                "rounds_run": self.rounds_run,
                "admitted_batches": self._batches,
                "in_flight": len(self.active),
                "partitions_streamed": self.partitions_streamed,
                "partitions_planned": int(sum(
                    len(f) for f in self.plan_footprints)),
                "vectors_streamed": self.vectors_streamed,
                "comparisons": self.comparisons,
                "partials": self.partials,
                "failures": self.failures,
                "failed_batches": self.failed_batches,
                "scan_faults": self.scan_faults,
                "scan_retries_used": self.scan_retries_used,
                "effective_target": self.target,
                "probe_frac": self.probe_frac,
            }


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------

class ServingRuntime:
    """Admission queue + riding scheduler + result cache + drift-triggered
    maintenance over one dynamic :class:`QuakeIndex`.

    Queries enter through :meth:`submit_query` / :meth:`submit_batch` and
    complete asynchronously (``flush_size`` admissions force a flush,
    ``flush_deadline``/``flush_deadline_ms`` bounds how long a queued
    query can wait — enforced at admission time and by a background
    ticker thread so a lone query still flushes with no further
    arrivals).  Writes are barriers: they drain the in-flight
    population, mutate the index, invalidate cache entries through the
    journal delta, and give the maintenance scheduler a chance to run.
    :meth:`drain` completes everything in flight; :meth:`result` returns
    a query's :class:`QueryResult`.

    **Threading model** (docs/serving.md): safe for concurrent
    ``submit_*`` / ``result`` / ``stats`` callers.  Two runtime locks —
    ``_engine_lock`` (reentrant, outermost) serializes all *blocking*
    engine work: flush bodies, scheduler rounds, write barriers,
    maintenance; ``_lock`` (the admission lock) is held only for queue /
    results / counter bookkeeping and is never held across blocking
    calls (quakecheck QK203 enforces this).  Lock order is declared in
    ``sanitize.LOCK_ORDER``; component locks
    (``RoundScheduler._lock`` / ``ResultCache._lock`` /
    ``MaintenanceScheduler._lock``) nest inside.  The coalescing
    determinism contract survives concurrency: the engine lock totally
    orders admissions and writes, and with ``record_admissions`` that
    order is logged so a single-threaded replay reproduces identical
    results.
    """

    def __init__(self, index: QuakeIndex,
                 config: Optional[ServingConfig] = None,
                 maintainer: Optional[Maintainer] = None,
                 lam: Optional[LatencyModel] = None,
                 clock: Optional[Callable[[], float]] = None,
                 faults: Optional[FaultInjector] = None):
        self.index = index
        self.cfg = config or ServingConfig()
        self.target = (self.cfg.recall_target
                       if self.cfg.recall_target is not None
                       else index.config.recall_target)
        self._engine_lock = TrackedLock("ServingRuntime._engine_lock")
        self._lock = TrackedLock("ServingRuntime._lock")
        self._clock = clock or time.perf_counter
        self._faults = faults
        self.executor = mq.BatchedSearchExecutor(
            index, impl=self.cfg.impl, storage_dtype=self.cfg.storage_dtype,
            planner=self.cfg.planner, rounds=self.cfg.rounds)
        # no partition padding (part_bucket=1): the reference pads to a
        # multiple of 32 with sticky growth slack so XLA keeps one
        # compiled shape across maintenance; the port's kernels take any
        # shape, so padding would only hold card memory
        self.cache = (ResultCache(self.cfg.cache_entries,
                                  bits=self.cfg.cache_bits,
                                  tol=self.cfg.cache_tol,
                                  seed=self.cfg.cache_seed)
                      if self.cfg.cache_entries > 0 else None)
        maintainer = maintainer or Maintainer(index, lam
                                              or LatencyModel(dim=index.dim))
        if faults is not None:
            maintainer.faults = faults
        self.maintenance = MaintenanceScheduler(
            maintainer,
            MaintenanceTriggers(
                min_ops=self.cfg.maint_min_ops,
                dirty_frac=self.cfg.maint_dirty_frac,
                cost_drift=self.cfg.maint_cost_drift,
                access_shift=self.cfg.maint_access_shift,
                max_ops=self.cfg.maint_max_ops))
        # observability bundle (obs/, docs/observability.md): the
        # registry/tracer/calibration locks rank innermost in
        # sanitize.LOCK_ORDER, so every hook below is legal under any
        # runtime lock.  cfg.metrics=False leaves it None — every hook
        # is then a None check and results are byte-identical
        self.obs = (Observability(
            lam=maintainer.lam,
            trace_capacity=self.cfg.trace_capacity,
            calibration_window=self.cfg.calibration_window)
            if self.cfg.metrics else None)
        self.scheduler = RoundScheduler(
            self.executor, self.cfg.k, self.target,
            rounds=self.cfg.rounds, early_exit=self.cfg.early_exit,
            b_bucket=self.cfg.b_bucket,
            record_stats=self.cfg.record_stats,
            scan_backend=self.cfg.scan_backend,
            clock=self._clock, faults=faults,
            scan_retries=self.cfg.scan_retries,
            scan_backoff_s=self.cfg.scan_backoff_s,
            scan_backoff_max_s=self.cfg.scan_backoff_max_s,
            obs=self.obs)
        # durability: WAL + checkpoint store (docs/durability.md).  The
        # attach writes a baseline checkpoint of the index as handed in;
        # fault injection arms only after that (startup is not a
        # steady-state crash point)
        self.durability = (DurabilityManager(
            index, self.cfg.wal_dir, fsync=self.cfg.fsync,
            wal_batch_ops=self.cfg.wal_batch_ops,
            ckpt_every_ops=self.cfg.ckpt_every_ops,
            keep_checkpoints=self.cfg.keep_checkpoints, faults=faults)
            if self.cfg.wal_dir is not None else None)
        self.recovery_report: Optional[RecoveryReport] = None
        # queue entries: (qid, query, t_submit, absolute deadline | None)
        self._queue: List[Tuple[int, np.ndarray, float,
                                Optional[float]]] = []
        self._maintaining = False
        self._next_qid = 0
        self.results: Dict[int, QueryResult] = {}
        self._cache_version = index.version
        self._admission_log: List[tuple] = []
        self._admit_gen: Dict[int, int] = {}
        self.queries_submitted = 0
        self.cache_hits = 0
        self.write_ops = 0
        # failure / degradation telemetry (docs/serving.md)
        self.shed_queries = 0
        self._status_counts = {s: 0 for s in TERMINAL_STATUSES}
        self.cache_errors = 0
        self._cache_disabled = False
        self.ticker_errors = 0
        self.ticker_restarts = 0
        self.ticker_wedged = False
        self.maintenance_failures = 0
        self._overflow_since_flush = False
        self._base_target = self.target
        self._govern_steps = 0
        self._pressure_streak = 0
        self._calm_streak = 0
        self._govern_degrades = 0
        self._govern_restores = 0
        self._closed = False
        self._ticker_wake = threading.Event()
        self._ticker_error: Optional[BaseException] = None
        self._ticker_thread: Optional[threading.Thread] = None
        self._ensure_ticker()

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Stop the deadline ticker (idempotent).  Queued / in-flight
        work is left as is — call :meth:`drain` first to finish it.

        A ticker that fails to join within 5 s is *wedged* (stuck in a
        scan or a lock) — that is logged, counted in
        ``stats()['ticker_wedged']``, and the thread reference is kept
        so the condition stays observable, instead of being silently
        dropped."""
        self._closed = True
        self._ticker_wake.set()
        t = self._ticker_thread
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                with self._lock:
                    self.ticker_wedged = True
                logger.error(
                    "serving ticker did not stop within 5s join budget "
                    "(wedged in a scan or lock); thread left daemonized "
                    "— see stats()['ticker_wedged']")
            else:
                self._ticker_thread = None
        if self.durability is not None:
            self.durability.close()
        if not self.scheduler.has_active():
            # free the device snapshot; a later search rebuilds it
            self.scheduler.release_snapshot()
            self.executor.release()

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @classmethod
    def recover(cls, wal_dir: str,
                config: Optional[ServingConfig] = None,
                device="cuda", **kwargs) -> "ServingRuntime":
        """Crash recovery entry point: rebuild the index on ``device``
        from the newest *valid* checkpoint plus the WAL suffix under
        ``wal_dir`` (fingerprint-verified, torn tail truncated —
        ``durability.recover_index``), then serve it with durability
        re-attached to the same directory.  The attach writes a fresh
        baseline checkpoint of the recovered state, so the next crash
        recovers from here even if the old WAL was damaged.  Details of
        what was recovered are on ``runtime.recovery_report``."""
        idx, report = recover_index(wal_dir, device=device)
        cfg = replace(config, wal_dir=wal_dir) if config is not None \
            else ServingConfig(wal_dir=wal_dir)
        rt = cls(idx, cfg, **kwargs)
        rt.recovery_report = report
        return rt

    # -- admission -----------------------------------------------------

    def submit_query(self, q: np.ndarray,
                     deadline_s: Optional[float] = None) -> int:
        """Admit one query; returns its ticket (qid).  Thread-safe: the
        admission lock covers ticketing, the cache probe and enqueueing;
        the flush a size/deadline trigger forces runs *after* it drops
        (blocking work never happens under the admission lock).

        ``deadline_s`` is this query's latency budget (overrides
        ``cfg.deadline_s``; None = config default): past it the query
        retires at the end of the current round with its running top-k,
        status ``PARTIAL``.  A full bounded queue applies
        ``cfg.queue_policy``: ``shed-newest`` completes this query
        immediately with status ``SHED``, ``shed-oldest`` sheds the
        oldest queued query instead, ``block`` makes this submitter pay
        for a flush and retry (backpressure)."""
        q = np.ascontiguousarray(q, dtype=np.float32).reshape(-1)
        if deadline_s is None:
            deadline_s = self.cfg.deadline_s
        elif deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive "
                             f"(got {deadline_s})")
        self._ensure_ticker()
        while True:
            now = self._clock()
            do_flush = False
            overflow = False
            with self._lock:
                note_guarded(self, "_queue")
                cap = self.cfg.queue_cap
                if cap is not None and len(self._queue) >= cap:
                    policy = self.cfg.queue_policy
                    if policy == "shed-newest":
                        qid = self._alloc_qid_locked()
                        self._shed_locked(qid, now, now)
                        return qid
                    elif policy == "shed-oldest":
                        old_qid, _oq, old_t, _od = self._queue.pop(0)
                        self._shed_locked(old_qid, old_t, now)
                    else:   # block: this submitter pays for a flush,
                            # then retries — backpressure without holding
                            # the admission lock across blocking work
                        self._overflow_since_flush = True
                        overflow = True
                if not overflow:
                    qid = self._alloc_qid_locked()
                    if self.cache is not None and not self._cache_disabled:
                        if self.index.version != self._cache_version:
                            self._invalidate_cache_locked()  # out-of-band
                        hit = self._cache_guarded(
                            self.cache.get, q, self.cfg.k)
                        if hit is not None:
                            self.cache_hits += 1
                            self._status_counts[STATUS_OK] += 1
                            latency = self._clock() - now
                            self.results[qid] = QueryResult(
                                ids=hit["ids"].copy(),
                                dists=hit["dists"].copy(),
                                nprobe=hit["nprobe"],
                                recall_estimate=hit["recall_estimate"],
                                from_cache=True,
                                latency_s=latency)
                            if self.obs is not None:
                                self.obs.metrics.observe(
                                    "serving.latency_s", latency)
                                self.obs.tracer.close_many(({
                                    "qid": qid, "status": STATUS_OK,
                                    "events": [
                                        {"e": "admit", "t": now},
                                        {"e": "cache_hit",
                                         "t": now + latency},
                                        {"e": "done",
                                         "t": now + latency,
                                         "status": STATUS_OK,
                                         "cache": True,
                                         "latency_s": latency}]},))
                            return qid
                    deadline = (None if deadline_s is None
                                else now + deadline_s)
                    # the admit trace event is deferred to flush time
                    # (the queue entry carries the admit timestamp): a
                    # per-submit tracer acquisition is measurable on the
                    # hot path, a batched one at flush is not
                    self._queue.append((qid, q, now, deadline))
                    do_flush = len(self._queue) >= self.cfg.flush_size or (
                        self.cfg.flush_deadline is not None
                        and now - self._queue[0][2]
                        >= self.cfg.flush_deadline)
            if overflow:
                self.flush()
                continue
            if do_flush:
                self.flush()
            return qid

    def _alloc_qid_locked(self) -> int:
        # caller holds self._lock (propagated seed)
        qid = self._next_qid
        self._next_qid += 1
        self.queries_submitted += 1
        return qid

    def _shed_locked(self, qid: int, t_submit: float, now: float) -> None:
        # caller holds self._lock (propagated seed).  SHED is terminal:
        # the query completes immediately, empty-handed but accounted.
        self.shed_queries += 1
        self._status_counts[STATUS_SHED] += 1
        self.results[qid] = QueryResult(
            ids=np.full(self.cfg.k, -1, dtype=np.int64),
            dists=np.full(self.cfg.k, np.inf, dtype=np.float64),
            recall_estimate=0.0, latency_s=now - t_submit,
            status=STATUS_SHED)
        if self.obs is not None:
            self.obs.tracer.close_many(({
                "qid": qid, "status": STATUS_SHED,
                "events": [
                    {"e": "admit", "t": t_submit},
                    {"e": "done", "t": now, "status": STATUS_SHED,
                     "latency_s": now - t_submit}]},))

    def _cache_guarded(self, fn, *args, **kwargs):
        """One cache-backend call; a failure degrades the runtime to
        cache-off mode (counted, logged) instead of erroring the query
        that happened to probe — the cache is an optimization, never a
        correctness dependency."""
        try:
            if self._faults is not None:
                self._faults.check("cache")
            return fn(*args, **kwargs)
        except Exception as e:
            with self._lock:    # reentrant under the admission lock
                self.cache_errors += 1
                self._cache_disabled = True
            logger.warning("cache backend failed (%r): degrading to "
                           "cache-off mode", e)
            return None

    def submit_batch(self, queries: np.ndarray,
                     deadline_s: Optional[float] = None) -> List[int]:
        """Admit a query batch (one qid per row)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        return [self.submit_query(q[i], deadline_s=deadline_s)
                for i in range(q.shape[0])]

    # -- deadline ticker ----------------------------------------------

    def tick(self) -> bool:
        """One deadline check: when the oldest queued query has waited
        past ``flush_deadline``, admit the queue and run it to
        completion (a deadline exists to bound answer latency — leaving
        the batch in flight for the next admission to finish would miss
        the point under light traffic).  Called by the background ticker
        thread; fake-clock tests call it directly.  Returns whether a
        flush ran."""
        deadline = self.cfg.flush_deadline
        if deadline is None:
            return False
        if self._faults is not None:
            self._faults.check("ticker")
        with self._lock:
            due = bool(self._queue) and (
                self._clock() - self._queue[0][2] >= deadline)
        if due:
            with self._engine_lock:
                self._drain_engine()
        return due

    def _ticker_loop(self) -> None:
        period = max(self.cfg.flush_deadline / 4.0, 1e-3)
        while not self._closed:
            self._ticker_wake.wait(period)
            if self._closed:
                break
            try:
                self.tick()
            except BaseException as e:
                # record the death and exit; the next admission notices
                # the dead thread and restarts the ticker (counted in
                # stats()['ticker_restarts']) — deadline flushes degrade
                # for at most one inter-arrival gap, never silently die
                self._ticker_error = e
                with self._lock:
                    self.ticker_errors += 1
                logger.warning("serving ticker died (%r); will restart "
                               "on next admission", e)
                break

    def _ensure_ticker(self) -> None:
        """Start — or restart, after a ticker death — the background
        deadline ticker.  Called at construction and on every admission,
        so a dead ticker is impossible to miss: the very next submit
        revives it.

        A ticker whose ``_ticker_error`` is set counts as dead even while
        its thread is still unwinding: ``_ticker_loop`` records the error
        before it counts ``ticker_errors`` and breaks, so a submit that
        saw the error counted could otherwise find the dying thread
        ``is_alive()`` and skip the restart.  The dying thread is not
        joined here (a blocking call under ``_lock``); it only returns."""
        if self.cfg.flush_deadline is None or not self.cfg.ticker \
                or self._closed:
            return
        with self._lock:
            t = self._ticker_thread
            if t is not None and t.is_alive() \
                    and self._ticker_error is None:
                return
            self._ticker_error = None
            if t is not None:
                self.ticker_restarts += 1
            t = threading.Thread(target=self._ticker_loop,
                                 name="serving-ticker", daemon=True)
            self._ticker_thread = t
            t.start()

    # -- scheduling ----------------------------------------------------

    def _ensure_radius(self) -> None:
        """Pin the APS radius for the current snapshot fingerprint with
        the deterministic resident-sample calibration, so batch planning
        never calibrates from whatever queries happened to coalesce."""
        cache = self.executor.planner_cache.ensure_fresh()
        if cache.get_radius(self.cfg.k, self.target) is None:
            cache.put_radius(self.cfg.k, self.target,
                             calibrate_radius_resident(self.index,
                                                       self.cfg.k))

    def flush(self) -> None:
        """Coalesce the queue into one executor batch, admit it to the
        riding scheduler, and advance in-flight rounds."""
        with self._engine_lock:
            self._flush_engine()

    def _flush_engine(self) -> None:
        with self._lock:
            note_guarded(self, "_queue")
            batch = list(self._queue)
            self._queue.clear()
            overflow = self._overflow_since_flush
            self._overflow_since_flush = False
        if self.cfg.govern:
            self._govern(len(batch), overflow)
        if batch:
            if (self.scheduler.has_active()
                    and self.executor._fingerprint()
                    != self.scheduler.epoch_key()):
                self.scheduler.drain()     # out-of-band mutation barrier
            self._ensure_radius()
            qids = [t[0] for t in batch]
            qs = np.stack([t[1] for t in batch])
            ts = [t[2] for t in batch]
            dls = [t[3] for t in batch]
            gen = self.cache.generation if self.cache is not None else 0
            with self._lock:
                for qid in qids:
                    self._admit_gen[qid] = gen
                if self.cfg.record_admissions:
                    self._admission_log.append(("q", tuple(qids)))
            self.scheduler.admit(qs, qids, ts, deadlines=dls)
            if self.obs is not None:
                # the queue-wait distribution lives in the registry;
                # the span's admit/flush events are synthesized at read
                # time from the terminal record's t_submit/batch and
                # the scheduler's flush metadata — no per-query tracer
                # work on this path
                t_adm = self._clock()
                waits = [t_adm - ft for ft in ts]
                self.obs.metrics.update(
                    counters={"serving.flushes": 1},
                    observations={"serving.queue_wait_s": waits})
            self.maintenance.note_op()
        for _ in range(max(self.cfg.interleave_rounds, 0)):
            if not self.scheduler.step():
                break
        self._collect()

    def _govern(self, batch_fill: int, overflow: bool) -> None:
        """Degradation governor (docs/serving.md): under sustained queue
        pressure, step the scheduler's effective recall target down
        (``govern_step`` per step, floored at ``govern_min_target``) and
        cap per-query probe budgets (``govern_probe_frac ** steps`` —
        the serving-layer union_cap analog); restore stepwise on
        sustained calm.  Pressure = an admission hit the queue cap since
        the last flush, or the flush drained >= ``govern_high *
        queue_cap`` queries; calm = no overflow and < ``govern_low *
        queue_cap``.  ``govern_patience`` consecutive signals are
        required per transition; every transition is counted."""
        cap = self.cfg.queue_cap
        if cap is None:
            return
        pressured = overflow or batch_fill >= self.cfg.govern_high * cap
        calm = (not overflow) and batch_fill < self.cfg.govern_low * cap
        with self._lock:
            if pressured:
                self._pressure_streak += 1
                self._calm_streak = 0
            elif calm:
                self._calm_streak += 1
                self._pressure_streak = 0
            else:
                self._pressure_streak = 0
                self._calm_streak = 0
            steps = self._govern_steps
            if (pressured
                    and self._pressure_streak >= self.cfg.govern_patience
                    and steps < self.cfg.govern_max_steps):
                steps += 1
                self._pressure_streak = 0
                self._govern_degrades += 1
            elif (calm and self._calm_streak >= self.cfg.govern_patience
                    and steps > 0):
                steps -= 1
                self._calm_streak = 0
                self._govern_restores += 1
            prev = self._govern_steps
            if steps == prev:
                return
            self._govern_steps = steps
        target = max(self.cfg.govern_min_target,
                     self._base_target - self.cfg.govern_step * steps)
        frac = (None if steps == 0
                else self.cfg.govern_probe_frac ** steps)
        self.scheduler.set_degradation(target, frac)
        logger.info("governor %s to step %d (target %.3f, probe_frac %s)",
                    "degraded" if steps > prev else "restored",
                    steps, target, frac)

    def drain(self) -> None:
        """Flush the queue and run rounds until nothing is in flight.
        Drains are also where read-only streams get their maintenance
        check: without it the access-shift trigger (read-skew drift) and
        the op-budget backstop could only ever fire on a write barrier."""
        with self._engine_lock:
            self._drain_engine()
        self.maybe_maintain()

    def _drain_engine(self) -> None:
        self._flush_engine()
        self.scheduler.drain()
        self._collect()

    def _collect(self) -> None:
        if self.obs is not None:
            # deferred round events first, so a span that completes in
            # this pass still reads admit -> flush -> round* -> done
            self.scheduler.flush_obs()
        done_lat, done_events = [], []
        t_done = self._clock() if self.obs is not None else 0.0
        for qid, res, q, footprint in self.scheduler.take_done():
            with self._lock:
                note_guarded(self, "results")
                self.results[qid] = res
                self._status_counts[res.status] += 1
                gen = self._admit_gen.pop(qid, None)
                cache_on = (self.cache is not None
                            and not self._cache_disabled)
            if self.obs is not None:
                done_lat.append(res.latency_s)
                # one compact DONE_FIELDS tuple per query — the span's
                # admit/flush/round events are synthesized at read time
                # from t_submit/batch and the scheduler metadata
                done_events.append((
                    qid, t_done, res.status, res.rounds, res.nprobe,
                    float(res.recall_estimate), res.latency_s,
                    res.t_submit, res.batch))
            # only OK results enter the cache: PARTIAL top-k is whatever
            # the budget allowed (serving it to a later identical query
            # would silently repeat the degradation), FAILED has no data
            if cache_on and res.status == STATUS_OK and q is not None:
                self._cache_guarded(
                    self.cache.put, q, self.cfg.k, res.ids, res.dists,
                    footprint, nprobe=res.nprobe,
                    recall_estimate=res.recall_estimate, gen=gen)
        if self.obs is not None and done_events:
            # batched post-loop recording: one registry and one tracer
            # acquisition per collect pass, not per completed query
            self.obs.metrics.update(
                observations={"serving.latency_s": done_lat})
            self.obs.tracer.close_many(done_events)

    def result(self, qid: int) -> Optional[QueryResult]:
        """The query's result, or None while it is still in flight."""
        with self._lock:
            note_guarded(self, "results")
            return self.results.get(qid)

    # -- writes (barriers) --------------------------------------------

    def submit_insert(self, x: np.ndarray, ids: np.ndarray) -> None:
        with self._engine_lock:
            self._drain_engine()
            if self.durability is not None:
                # write-ahead, in engine-lock (= admission) order: if the
                # append crashes, the op was never applied — recovery
                # lands on the prefix before it
                self.durability.log_insert(x, ids)
            self.index.insert(x, ids)
            if self.cfg.record_admissions:
                with self._lock:
                    self._admission_log.append(
                        ("insert", np.array(x, copy=True),
                         np.array(ids, copy=True)))
            self._after_write()

    def submit_delete(self, ids: np.ndarray) -> int:
        with self._engine_lock:
            self._drain_engine()
            if self.durability is not None:
                self.durability.log_delete(ids)
            removed = self.index.delete(ids)
            if self.cfg.record_admissions:
                with self._lock:
                    self._admission_log.append(
                        ("delete", np.array(ids, copy=True)))
            self._after_write()
            return removed

    def _after_write(self) -> None:
        with self._lock:
            self.write_ops += 1
            self._invalidate_cache_locked()
        self.maintenance.note_op()
        self.maybe_maintain()
        # cadence checkpoint (callers hold the engine lock; never under
        # the admission lock — this is disk I/O).  A post-maintenance
        # forced checkpoint just above resets the cadence, so at most
        # one checkpoint runs per write
        if self.durability is not None and self.durability.checkpoint_due():
            self.durability.checkpoint()

    def _invalidate_cache_locked(self) -> None:
        # callers hold self._lock (propagated seed); serializing the
        # version check with admission-side cache probes is the point
        if self.cache is None:
            self._cache_version = self.index.version
            return
        delta = self.index.journal.delta_since(self._cache_version)
        if delta is None or delta.structural:
            self.cache.clear()
        elif delta.dirty:
            self.cache.invalidate_partitions(delta.dirty)
        self._cache_version = self.index.version

    def admission_log(self) -> List[tuple]:
        """Copy of the recorded admission order (engine-lock total
        order); requires ``cfg.record_admissions``."""
        with self._lock:
            return list(self._admission_log)

    def maybe_maintain(self, force: bool = False
                       ) -> Optional[MaintenanceReport]:
        """Run a maintenance pass if a drift trigger fired (or forced).
        In-flight work is drained first (maintenance is a barrier);
        maintenance mutations then invalidate the cache through the same
        journal path as writes."""
        with self._engine_lock:
            with self._lock:
                if self._maintaining:
                    return None
                self._maintaining = True
            try:
                if not force and self.maintenance.due() is None:
                    return None
                self._drain_engine()
                ver_before = self.index.version
                ckpt = checkpoint_index(self.index)
                try:
                    rep = self.maintenance.run_if_due(force=force)
                except Exception as e:
                    # self-healing: a maintenance crash mid-recluster
                    # rolls the index (levels, id map, journal version)
                    # back to the pre-pass checkpoint, so snapshots,
                    # planner caches and the result cache stay coherent.
                    # Trigger state was not rebaselined, so the next
                    # drift check retries the pass.
                    restore_index(self.index, ckpt)
                    with self._lock:
                        self.maintenance_failures += 1
                    logger.warning("maintenance pass crashed (%r): "
                                   "rolled back, will retry on next "
                                   "trigger", e)
                    return None
                if rep is not None:
                    if self.obs is not None:
                        # maintenance-decision audit record: which
                        # trigger fired and what the pass changed
                        hist = self.maintenance.snapshot()["history"]
                        reason = (hist[-1].get("reason", "forced")
                                  if hist else "forced")
                        reg = self.obs.metrics
                        reg.inc(f"maintenance.trigger.{reason}")
                        reg.inc("maintenance.splits", int(rep.splits))
                        reg.inc("maintenance.merges", int(rep.merges))
                        self.obs.tracer.audit("maintenance", {
                            "t": self._clock(), "reason": reason,
                            "splits": int(rep.splits),
                            "merges": int(rep.merges),
                            "cost_before": float(rep.cost_before),
                            "cost_after": float(rep.cost_after)})
                    with self._lock:
                        self._invalidate_cache_locked()
                    if self.durability is not None \
                            and self.index.version != ver_before:
                        # maintenance effects are NOT replayable from the
                        # WAL (they depend on served access statistics
                        # the log does not carry), so a committed pass is
                        # made durable immediately, before serving
                        # resumes.  A crash before this checkpoint's
                        # rename loses the pass — the same rollback
                        # semantics as an in-process maintenance crash;
                        # consistent, because no write follows it yet.
                        self.durability.log_maintenance(
                            f"splits={rep.splits},merges={rep.merges},"
                            f"level_added={rep.level_added},"
                            f"level_removed={rep.level_removed}")
                        self.durability.checkpoint(force=True)
                return rep
            finally:
                with self._lock:
                    self._maintaining = False

    # -- telemetry -----------------------------------------------------

    def stats(self) -> dict:
        """Deep-copied, per-component lock-consistent snapshot.  Takes
        the admission and component locks (never the engine lock, which
        may be mid-scan) — each component's counters are internally
        consistent; cross-component skew is bounded by what completed
        between the snapshots."""
        sch = self.scheduler.snapshot()
        maint = self.maintenance.snapshot()
        cache = self.cache.counters() if self.cache is not None else None
        with self._lock:
            out = {
                "queries_submitted": self.queries_submitted,
                "queries_completed": len(self.results),
                "queue_depth": len(self._queue),
                "cache_hits": self.cache_hits,
                "write_ops": self.write_ops,
                "queries_shed": self.shed_queries,
                "status_counts": dict(self._status_counts),
                "cache_errors": self.cache_errors,
                "cache_disabled": self._cache_disabled,
                "ticker_errors": self.ticker_errors,
                "ticker_restarts": self.ticker_restarts,
                "ticker_wedged": self.ticker_wedged,
                "maintenance_failures": self.maintenance_failures,
                "governor": {
                    "steps": self._govern_steps,
                    "degrades": self._govern_degrades,
                    "restores": self._govern_restores,
                },
            }
        out["cache_entries"] = cache["entries"] if cache else 0
        out["cache_invalidated"] = cache["invalidated"] if cache else 0
        out["cache_stale_puts"] = cache["stale_puts"] if cache else 0
        planned = sch["partitions_planned"]
        out.update({
            "rounds_run": sch["rounds_run"],
            "admitted_batches": sch["admitted_batches"],
            "in_flight": sch["in_flight"],
            "partitions_streamed": sch["partitions_streamed"],
            "partitions_planned": planned,
            "riding_savings": round(
                1.0 - sch["partitions_streamed"] / planned, 4)
            if planned else 0.0,
            "vectors_streamed": sch["vectors_streamed"],
            "comparisons": sch["comparisons"],
            "partials": sch["partials"],
            "failures": sch["failures"],
            "failed_batches": sch["failed_batches"],
            "scan_faults": sch["scan_faults"],
            "scan_retries_used": sch["scan_retries_used"],
            "effective_target": sch["effective_target"],
            "probe_frac": sch["probe_frac"],
            "maintenance_runs": maint["runs"],
            "maintenance_reasons": maint["reasons"],
        })
        # journal overflow surfaces the silent data-loss window: past the
        # trim floor, delta consumers (snapshot caches, incremental
        # checkpoints) fall back to full rebuilds (GIL-atomic scalars;
        # no lock needed)
        out["journal_overflowed"] = self.index.journal.overflowed
        out["journal_overflow_count"] = self.index.journal.overflow_count
        out["durability"] = (self.durability.stats()
                             if self.durability is not None else None)
        return out

    def metrics_snapshot(self) -> dict:
        """Unified exposition: one flat dict of every counter the stack
        exposes, under stable dotted names (docs/observability.md pins
        them).
        Merges the federated ``stats()`` components (``serving.*``,
        ``serving.status.*``, ``serving.governor.*``, ``maintenance.*``,
        ``durability.*``), fault-injection arrival/trip counts
        (``faults.*``), the sanitizer's compile/concurrency bridge
        (``sanitize.*``), and — when ``cfg.metrics`` is on — the live
        registry (histograms flattened to ``<name>.p50`` etc.) plus
        tracer counters (``trace.*``).  Values are numbers only:
        booleans become 0/1, lists/strings/None are dropped.  Renders
        to Prometheus text via ``obs.to_prometheus``."""
        flat: dict = {}

        def put(prefix, mapping):
            for key, v in mapping.items():
                name = f"{prefix}.{key}"
                if isinstance(v, dict):
                    put(name, v)
                elif isinstance(v, bool):
                    flat[name] = int(v)
                elif isinstance(v, (int, float)):
                    flat[name] = v

        st = self.stats()
        durability = st.pop("durability", None)
        st.pop("maintenance_reasons", None)     # re-counted below
        put("serving", {k: v for k, v in st.items()
                        if k not in ("status_counts", "governor",
                                     "maintenance_runs")})
        put("serving.status", st.get("status_counts", {}))
        put("serving.governor", st.get("governor", {}))
        maint = self.maintenance.snapshot()
        flat["maintenance.runs"] = maint["runs"]
        flat["maintenance.ops_since"] = maint["ops_since"]
        for reason in maint["reasons"]:
            key = f"maintenance.trigger.{reason}"
            flat[key] = flat.get(key, 0) + 1
        if durability:
            put("durability", durability)
        if self._faults is not None:
            put("faults", self._faults.counters())
        put("sanitize", observability_counters())
        if self.obs is not None:
            self.scheduler.flush_obs()  # don't lag in-flight rounds
            put("trace", self.obs.tracer.counters())
            flat.update(self.obs.metrics.snapshot())
        return flat
