"""Per-query trace spans, recorded compactly and expanded at read time.

Span lifecycle (docs/observability.md has the full diagram):

    admit ──┬── cache_hit ──────────────┬── done(status, ...)
            ├── (shed) ─────────────────┤
            └── flush ── round* ────────┘

The hot path never builds that event list.  It records three compact
streams — one terminal record per query (``close_many``), one metadata
record per coalesced flush (``note_flushes``), and one per scheduler
round with the qids that took cells (``note_rounds``) — and ``spans()``
joins them back into per-query event lists on demand.  A query's span
costs one dict and one ring append on the serving path instead of one
tracer acquisition and one event dict per lifecycle stage; the
obs-overhead bench cell gates exactly this.

Cache hits and shed queries complete at a single instant, so those
paths pass a prebuilt ``{"qid", "status", "events": [...]}`` record
through ``close_many`` unchanged.

Timestamps come from the runtime's injectable monotonic clock, so
traces are deterministic under fake clocks and are *durations*, not
wall-clock dates (QK401, docs/static_analysis.md).

``QueryTracer._lock`` sits next-to-innermost in
``repro_torch.sanitize.LOCK_ORDER``: recording is legal under any runtime
lock and acquires nothing else.

Beside the per-query tracer sits the executor's span primitive:
:func:`span` names a stretch of host work of the batched search path
(``quake.<name>``), :func:`count` bumps an event counter, and
:func:`program_totals` reads both back.  They are on only while
``torch.profiler`` records: then a span enters a profiler record
function (on the profiler's clock, nested under whatever is open) and
adds its host time to a process-wide :class:`MetricsRegistry`, in one
``update`` when the outermost span of the thread closes.  Off, a span
is one flag read.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Mapping

import torch
from torch.autograd import profiler as _profiler

from ..sanitize import TrackedLock, note_guarded
from .registry import MetricsRegistry

__all__ = ["DONE_FIELDS", "QueryTracer", "count", "program_totals", "span"]

# field order of a compact terminal record (a plain tuple: building a
# dict per query on the serving hot path is measurable; building nine
# tuple slots is not) — expanded into the span's ``done`` event by
# ``spans()``
DONE_FIELDS = ("qid", "t", "status", "rounds", "nprobe",
               "recall_estimate", "latency_s", "t_submit", "batch")


def _json_default(o):
    try:
        return float(o)          # numpy scalars and the like
    except (TypeError, ValueError):
        return str(o)


class QueryTracer:
    """Bounded ring of per-query trace spans plus audit records."""

    def __init__(self, capacity: int = 1024):
        self._lock = TrackedLock("QueryTracer._lock")
        self.capacity = max(1, int(capacity))
        # terminal records and audits; oldest evicted first
        self._ring: deque = deque(maxlen=self.capacity)
        # span-synthesis metadata, bounded separately: flush records
        # keyed by batch id, round records carrying taker qids.  A span
        # whose metadata has been evicted just renders fewer events.
        self._flushes: deque = deque(maxlen=self.capacity)
        self._rounds: deque = deque(maxlen=4 * self.capacity)
        self.emitted = 0
        self.dropped = 0        # spans evicted from the ring

    # -- recording (hot path) ------------------------------------------
    def close_many(self, recs) -> None:
        """Record terminal records under ONE lock acquisition.  Each
        record either carries a prebuilt span (``{"qid", "status",
        "events": [...]}``) or is a compact ``DONE_FIELDS`` tuple that
        ``spans()`` expands against the flush/round metadata."""
        with self._lock:
            note_guarded(self, "_ring")
            ring = self._ring
            avail = ring.maxlen - len(ring)
            n = 0
            for rec in recs:
                ring.append(rec)
                n += 1
            self.emitted += n
            if n > avail:
                self.dropped += n - avail

    def note_flushes(self, recs) -> None:
        """Record flush metadata (``{"batch", "t", "n"}``) — one per
        coalesced admission, referenced by spans through their batch
        id."""
        with self._lock:
            note_guarded(self, "_flushes")
            self._flushes.extend(recs)

    def note_rounds(self, recs) -> None:
        """Record round metadata (``{"t", "round", "partitions",
        "vectors", "wall_s", "takers"}``) — one per scheduler round;
        ``takers`` lists the qids that took cells, which is how spans
        recover their per-round scan events."""
        with self._lock:
            note_guarded(self, "_rounds")
            self._rounds.extend(recs)

    def audit(self, kind: str, record: Mapping) -> None:
        """Append a non-query audit record (e.g. a maintenance decision:
        which trigger fired, split/merge deltas) to the same ring."""
        entry = {"audit": str(kind)}
        entry.update(record)
        with self._lock:
            note_guarded(self, "_ring")
            self._ring.append(entry)

    # -- reading -------------------------------------------------------
    def spans(self) -> List[dict]:
        """Completed spans and audit records, oldest first.  Compact
        terminal records are expanded here into the full
        admit -> flush -> round* -> done event list (treat the result
        as read-only)."""
        with self._lock:
            ring = list(self._ring)
            flushes = {f["batch"]: f for f in self._flushes}
            rounds = list(self._rounds)
        by_qid: Dict[int, List[dict]] = {}
        for rr in rounds:
            for qid in rr["takers"]:
                by_qid.setdefault(qid, []).append(rr)
        out = []
        for entry in ring:
            if isinstance(entry, dict):
                # prebuilt span (cache hit / shed) or audit record
                out.append(dict(entry))
                continue
            (qid, t, status, rounds_n, nprobe, recall_est, latency_s,
             t_submit, batch) = entry
            events = [{"e": "admit", "t": t_submit}]
            f = flushes.get(batch)
            if f is not None:
                events.append({"e": "flush", "t": f["t"],
                               "batch": f["batch"]})
            for rr in by_qid.get(qid, ()):
                events.append({"e": "round", "t": rr["t"],
                               "round": rr["round"],
                               "partitions": rr["partitions"],
                               "vectors": rr["vectors"],
                               "wall_s": rr["wall_s"]})
            events.append({"e": "done", "t": t, "status": status,
                           "rounds": rounds_n, "nprobe": nprobe,
                           "recall_estimate": recall_est,
                           "latency_s": latency_s})
            out.append({"qid": qid, "status": status, "events": events})
        return out

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"emitted": self.emitted, "dropped": self.dropped,
                    "completed": len(self._ring),
                    "flushes_tracked": len(self._flushes),
                    "rounds_tracked": len(self._rounds)}

    def dump_jsonl(self, path: str) -> int:
        """Write completed spans as JSON-lines; returns the span count."""
        spans = self.spans()
        with open(path, "w", encoding="utf-8") as f:
            for s in spans:
                f.write(json.dumps(s, default=_json_default) + "\n")
        return len(spans)


# ---------------------------------------------------------------------------
# Executor spans: on only while torch's profiler records
# ---------------------------------------------------------------------------

PREFIX = "quake."
WAIT = "wait"            # the span around a copy the host blocks on

# what the spans and counters add up to, over every thread of the process
_PROGRAM = MetricsRegistry()
_seq = itertools.count(1)
_tls = threading.local()
_OFF = contextlib.nullcontext()      # the span while the profiler is off


class _Thread:
    """One thread's open spans (each frame a one-slot list of the ns its
    ``quake.wait`` descendants took), the batch sequence number of the
    outermost one, and the totals not yet in the registry."""

    __slots__ = ("stack", "seq", "pending")

    def __init__(self):
        self.stack: List[list] = []
        self.seq = 0
        self.pending: Dict[str, int] = {}


def _thread() -> _Thread:
    st = getattr(_tls, "st", None)
    if st is None:
        st = _tls.st = _Thread()
    return st


def _flush(st: _Thread) -> None:
    if st.pending:
        pending, st.pending = st.pending, {}
        _PROGRAM.update(counters=pending)


class _Span:
    __slots__ = ("name", "args", "handle", "frame", "t0", "st")

    def __init__(self, name: str, args: tuple):
        self.name = name
        self.args = args

    def __enter__(self):
        st = self.st = _thread()
        if not st.stack:
            st.seq = next(_seq)
        # the batch number (and the span's own args) are the record
        # function's inputs: a trace taken with record_shapes shows them
        self.handle = torch.autograd._record_function_with_args_enter(
            PREFIX + self.name, st.seq, *self.args)
        self.frame = [0]
        st.stack.append(self.frame)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        torch.autograd._record_function_with_args_exit(self.handle)
        st = self.st
        stack = st.stack
        stack.pop()
        pend = st.pending
        key = PREFIX + self.name
        pend[key + ".count"] = pend.get(key + ".count", 0) + 1
        pend[key + ".ns"] = pend.get(key + ".ns", 0) + dt
        if self.name == WAIT:
            for frame in stack:
                frame[0] += dt
        else:
            pend[key + ".wait_ns"] = (pend.get(key + ".wait_ns", 0)
                                      + self.frame[0])
        if not stack:
            _flush(st)
        return False


def span(name: str, **args):
    """A context over host work named ``quake.<name>``.  While
    ``torch.profiler`` records, it enters a profiler record function
    whose inputs are the batch sequence number (shared by every span
    under one outermost span) and ``args`` (ints), and adds
    ``quake.<name>.count``, ``.ns`` (``time.perf_counter_ns``) and
    ``.wait_ns`` (the part spent in ``quake.wait`` descendants) to the
    program totals.  Otherwise it costs one flag read."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, tuple(args.values()))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``quake.<name>`` while the profiler
    records (with the open spans' totals, or at once outside any)."""
    if not _profiler._is_profiler_enabled:
        return
    st = _thread()
    key = PREFIX + name
    st.pending[key] = st.pending.get(key, 0) + n
    if not st.stack:
        _flush(st)


def program_totals() -> Dict[str, float]:
    """The spans' and counters' totals over the process so far, a flat
    dict under ``quake.`` names (empty until the profiler has recorded
    one)."""
    return _PROGRAM.snapshot()
