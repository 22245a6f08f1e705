"""Runtime sanitizer harness for the port's device-resident serving path.

Three composable guards, the PyTorch counterparts of the JAX package's:

* **Sync guard** — ``torch.cuda.set_sync_debug_mode("error")`` turns any
  synchronizing CUDA call inside the guarded region (a device-to-host
  pull, a pageable host-to-device copy, ``.item()``) into an error.  The
  declared transfer points of the hot path — the ones the quakecheck
  ``allow-sync`` pragma marks — run inside :func:`allow_sync`, a scoped
  allowance that restores the guard on exit, so the guarded region
  proves the path moves data only where it says it does.  Without CUDA
  the guard has nothing to watch and is a no-op.
* **NaN check** — :func:`check_finite` raises ``FloatingPointError`` when
  an array the serving round pulls back holds a NaN while the check is
  armed, so a kernel that produces NaNs fails loudly at the round that
  pulled them instead of propagating into results.
* **Build-event counter** — counts kernel-library builds and loads
  (``kernels.build.build_events``): the port's kernels are built by nvcc
  and loaded once per process, so an entry point's count is how many
  libraries it had to make ready.  ``compile_budget.json`` beside this
  module pins per-entry-point budgets (:func:`assert_compile_budget`);
  a warmed path must build nothing.

``sanitized()`` stacks them.

The fourth guard is the **concurrency sanitizer** — the runtime twin of
quakecheck's QK2xx lock-discipline rules (``tools/quakecheck``):

* :class:`TrackedLock` wraps ``threading.RLock`` with a rank from the
  declared :data:`LOCK_ORDER` and a per-thread held stack; acquiring
  against the order is counted always and raises inside an active
  :class:`LockOrderWatchdog`.
* :func:`note_guarded` is an eraser-style guarded-field access checker:
  each ``(object, field)`` access intersects the candidate lock-set
  across threads; two threads touching a field with no common lock is a
  guarded-field violation.
* :class:`ConcurrencyEvents` mirrors :class:`CompileEvents` — a counter
  scope over acquisitions / contention / order violations / guarded
  violations, so a hammer test asserts "zero violations" as a delta.

``sanitized(locks=True)`` arms the watchdog alongside the other guards.
"""
from __future__ import annotations

import contextlib
import functools
import json
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .kernels import build as _build

__all__ = ["compile_count", "compile_events", "sanitized", "allow_sync",
           "check_finite", "warm_until_stable", "load_compile_budget",
           "assert_compile_budget", "BUDGET_PATH",
           "LOCK_ORDER", "TrackedLock", "LockOrderWatchdog",
           "ConcurrencyEvents", "concurrency_counters", "note_guarded",
           "guarded_by", "observability_counters"]

BUDGET_PATH = Path(__file__).resolve().parent / "compile_budget.json"

_guard_lock = threading.Lock()
_nan_depth = 0           # > 0: check_finite raises on NaN


def compile_count() -> int:
    """Monotonic count of kernel-library builds and loads so far."""
    return _build.build_events()


class CompileEvents:
    """Counter scope: ``new()`` is the number of library builds since
    the scope opened (or since the last ``reset()``)."""

    def __init__(self) -> None:
        self._start = compile_count()

    def new(self) -> int:
        return compile_count() - self._start

    def reset(self) -> None:
        self._start = compile_count()


@contextlib.contextmanager
def compile_events() -> Iterator[CompileEvents]:
    yield CompileEvents()


def _sync_guard_available() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def _sync_mode(mode: int) -> Iterator[None]:
    """Set CUDA's sync debug mode for the block and restore it after."""
    if not _sync_guard_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def allow_sync(reason: str) -> Iterator[None]:
    """Scoped allowance for a declared synchronizing transfer (the
    runtime twin of ``# quakecheck: allow-sync(<reason>)``): inside the
    block the sync guard is off, on exit it is back as it was.  Empty
    reasons are refused, as the pragma refuses them."""
    if not reason or not reason.strip():
        raise ValueError("allow_sync needs a reason")
    if not _sync_guard_available() \
            or torch.cuda.get_sync_debug_mode() == 0:
        yield
        return
    with _sync_mode(0):
        yield


@contextlib.contextmanager
def _nan_checks() -> Iterator[None]:
    global _nan_depth
    with _guard_lock:
        _nan_depth += 1
    try:
        yield
    finally:
        with _guard_lock:
            _nan_depth -= 1


def check_finite(what: str, *arrays) -> None:
    """Raise ``FloatingPointError`` when the NaN check is armed and any
    of ``arrays`` (host numpy) holds a NaN.  ``inf`` is legal: it is the
    miss marker of a top-k row."""
    if _nan_depth <= 0:
        return
    for a in arrays:
        if np.isnan(np.asarray(a)).any():
            raise FloatingPointError(f"NaN in {what}")


@contextlib.contextmanager
def sanitized(transfers: bool = True, nans: bool = True,
              compiles: bool = True,
              locks: bool = False) -> Iterator[Optional[CompileEvents]]:
    """Run the enclosed block under the stacked sanitizers.

    Yields the :class:`CompileEvents` scope when ``compiles`` is on
    (else None).  With ``transfers`` on, device operands must be staged
    before entering — that is the point — and the path's own declared
    transfers run inside :func:`allow_sync`.  ``locks=True`` arms the
    :class:`LockOrderWatchdog` (lock-order violations raise, guarded
    field accesses are eraser-checked).
    """
    with contextlib.ExitStack() as stack:
        if transfers:
            stack.enter_context(_sync_mode(2))
        if nans:
            stack.enter_context(_nan_checks())
        if locks:
            stack.enter_context(LockOrderWatchdog())
        yield CompileEvents() if compiles else None


def warm_until_stable(fn, *, max_rounds: int = 8) -> int:
    """Call ``fn()`` until a call builds no kernel library.  Returns the
    number of warm calls made; raises if the count never settles."""
    ev = CompileEvents()
    for i in range(max_rounds):
        ev.reset()
        fn()
        if ev.new() == 0:
            return i + 1
    raise RuntimeError(
        f"build count did not stabilize after {max_rounds} warm calls")


def load_compile_budget(path: Optional[Path] = None) -> Dict[str, int]:
    """The per-entry-point build budgets (``compile_budget.json`` beside
    this module: ``{"budgets": {entry_point: max_builds}}``)."""
    p = Path(path) if path is not None else BUDGET_PATH
    with open(p, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return {k: int(v) for k, v in data["budgets"].items()}


def assert_compile_budget(entry_point: str, observed: int,
                          path: Optional[Path] = None) -> None:
    """Fail (AssertionError) if ``observed`` library builds exceed the
    entry point's pinned budget.  Unknown entry points fail too: a new
    hot path must declare its budget before it is gated."""
    budgets = load_compile_budget(path)
    if entry_point not in budgets:
        raise AssertionError(
            f"no build budget declared for {entry_point!r} in "
            f"{path or BUDGET_PATH} — add one (budgets: "
            f"{sorted(budgets)})")
    budget = budgets[entry_point]
    assert observed <= budget, (
        f"{entry_point}: {observed} library builds observed, budget is "
        f"{budget}")


# ---------------------------------------------------------------------------
# Concurrency sanitizer — runtime twin of quakecheck QK2xx
# ---------------------------------------------------------------------------

# Declared global lock partial order, outermost first.  This is the
# runtime twin of ``tools.quakecheck.config.LOCK_ORDER`` — a test
# asserts the two agree, so the linter and the watchdog can never drift
# apart.
LOCK_ORDER: Tuple[str, ...] = (
    "ServingRuntime._engine_lock",
    "ServingRuntime._lock",
    "RoundScheduler._lock",
    "ResultCache._lock",
    "MaintenanceScheduler._lock",
    # observability locks rank innermost: recording a metric, emitting a
    # trace event, or folding a calibration sample must be legal while
    # holding any runtime lock, and never the other way around
    # (docs/observability.md)
    "QueryTracer._lock",
    "CalibrationTracker._lock",
    "MetricsRegistry._lock",
)
_LOCK_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}

_cc_lock = threading.Lock()
_cc_counters = {"acquisitions": 0, "contended": 0,
                "order_violations": 0, "guarded_violations": 0}
_cc_violations: List[str] = []       # human-readable, capped
_VIOLATION_CAP = 64
_watchdog_depth = 0                  # > 0: strict mode (raise) + eraser on
_tls = threading.local()


def _held_stack() -> List["TrackedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _watchdog_active() -> bool:
    return _watchdog_depth > 0


def _record_violation(kind: str, message: str) -> None:
    with _cc_lock:
        _cc_counters[kind] += 1
        if len(_cc_violations) < _VIOLATION_CAP:
            _cc_violations.append(f"{kind}: {message}")
    if _watchdog_active():
        raise RuntimeError(f"concurrency sanitizer: {message}")


def concurrency_counters() -> Dict[str, int]:
    """Snapshot of the monotonic concurrency counters."""
    with _cc_lock:
        return dict(_cc_counters)


def concurrency_violations() -> List[str]:
    """The recorded violation messages (bounded buffer)."""
    with _cc_lock:
        return list(_cc_violations)


def observability_counters() -> Dict[str, int]:
    """Bridge for ``ServingRuntime.metrics_snapshot()``: the sanitizer's
    build-event and concurrency counters as one flat dict, so kernel
    builds and lock-order violations surface under the same dotted
    namespace as the serving metrics."""
    out: Dict[str, int] = dict(concurrency_counters())
    out["compile_count"] = compile_count()
    return out


class TrackedLock:
    """A reentrant lock that knows its name and its place.

    Drop-in for ``threading.RLock`` on the serving classes: context
    manager, ``acquire``/``release``, plus ``held()`` /
    ``assert_held()`` so guarded methods can verify their contract.
    Acquiring against :data:`LOCK_ORDER` while holding a later-ranked
    lock is always *counted*; under an active
    :class:`LockOrderWatchdog` it raises.
    """

    __slots__ = ("name", "_rank", "_inner", "_owner", "_depth")

    def __init__(self, name: str) -> None:
        self.name = name
        self._rank = _LOCK_RANK.get(name)
        self._inner = threading.RLock()
        self._owner: Optional[int] = None
        self._depth = 0

    def __repr__(self) -> str:
        return f"TrackedLock({self.name!r})"

    def held(self) -> bool:
        """True when the *calling thread* holds this lock."""
        return self._owner == threading.get_ident()

    def assert_held(self) -> None:
        if not self.held():
            raise AssertionError(
                f"{self.name} must be held here (see docs/serving.md "
                f"threading model)")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:                       # reentrant fast path
            self._inner.acquire()
            self._depth += 1
            return True
        if self._rank is not None:
            for held in _held_stack():
                if held._rank is not None and held._rank > self._rank:
                    _record_violation(
                        "order_violations",
                        f"acquiring '{self.name}' while holding "
                        f"'{held.name}' inverts LOCK_ORDER "
                        f"({' -> '.join(LOCK_ORDER)})")
        got = self._inner.acquire(False)
        if not got:
            with _cc_lock:
                _cc_counters["contended"] += 1
            if not blocking:
                return False
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        self._owner = me
        self._depth = 1
        _held_stack().append(self)
        with _cc_lock:
            _cc_counters["acquisitions"] += 1
        if _watchdog_active():
            _WATCHDOG_TRACE.append((me, self.name))
        return True

    def release(self) -> None:
        if self._owner != threading.get_ident():
            raise RuntimeError(f"releasing {self.name} from a thread "
                               f"that does not hold it")
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
            stack = _held_stack()
            if self in stack:
                stack.remove(self)
        self._inner.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# Bounded per-process acquisition trace (thread id, lock name), recorded
# only while a watchdog is active; LockOrderWatchdog.trace() filters it.
class _Trace:
    def __init__(self, cap: int = 4096) -> None:
        self._items: List[Tuple[int, str]] = []
        self._cap = cap
        self._lk = threading.Lock()

    def append(self, item: Tuple[int, str]) -> None:
        with self._lk:
            if len(self._items) < self._cap:
                self._items.append(item)

    def snapshot(self) -> List[Tuple[int, str]]:
        with self._lk:
            return list(self._items)

    def cut(self) -> int:
        with self._lk:
            return len(self._items)


_WATCHDOG_TRACE = _Trace()


# -- eraser-style guarded-field checker -------------------------------------

# (id(owner), field) -> [candidate lock-name set or None, thread-id set].
# Lockset algorithm (Savage et al.): the candidate set starts as the
# first access's held locks and is intersected on every later access; an
# empty candidate once a *second* thread has touched the field means no
# common lock protects it.
_eraser_lock = threading.Lock()
_eraser_state: Dict[Tuple[int, str], List] = {}


def note_guarded(owner: object, field: str) -> None:
    """Record an access to ``owner.<field>`` under the current thread's
    lock-set.  No-op unless a :class:`LockOrderWatchdog` is active, so
    production paths can call it unconditionally."""
    if not _watchdog_active():
        return
    held = frozenset(lk.name for lk in _held_stack())
    me = threading.get_ident()
    key = (id(owner), field)
    with _eraser_lock:
        st = _eraser_state.get(key)
        if st is None:
            _eraser_state[key] = [set(held), {me}]
            return
        st[0] &= held
        st[1].add(me)
        violation = len(st[1]) >= 2 and not st[0]
        if violation:                    # reset so we report once
            st[0] = set(held)
            st[1] = {me}
    if violation:
        _record_violation(
            "guarded_violations",
            f"field '{type(owner).__name__}.{field}' accessed by "
            f"multiple threads with no common lock (eraser lockset "
            f"empty)")


def guarded_by(lock_name: str):
    """Runtime twin of the static ``@guarded_by`` annotation: marks the
    method (quakecheck seeds its lock-set from the same decorator) and,
    under an active watchdog, asserts the named lock is actually held on
    entry.  ``lock_name`` is an attribute of ``self`` (``"_lock"``)."""
    attr = lock_name.rsplit(".", 1)[-1]

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if _watchdog_active():
                lk = getattr(self, attr, None)
                if isinstance(lk, TrackedLock) and not lk.held():
                    _record_violation(
                        "guarded_violations",
                        f"{type(self).__name__}.{fn.__name__} declared "
                        f"@guarded_by({lock_name!r}) but the lock is "
                        f"not held")
            return fn(self, *args, **kwargs)
        wrapper.__quakecheck_guarded_by__ = lock_name
        return wrapper
    return deco


class ConcurrencyEvents:
    """Counter scope over the concurrency sanitizer, mirroring
    :class:`CompileEvents`: each property is the delta since the scope
    opened (or the last ``reset()``)."""

    def __init__(self) -> None:
        self._start = concurrency_counters()

    def _delta(self, key: str) -> int:
        return concurrency_counters()[key] - self._start[key]

    @property
    def acquisitions(self) -> int:
        return self._delta("acquisitions")

    @property
    def contended(self) -> int:
        return self._delta("contended")

    @property
    def order_violations(self) -> int:
        return self._delta("order_violations")

    @property
    def guarded_violations(self) -> int:
        return self._delta("guarded_violations")

    def violations(self) -> int:
        return self.order_violations + self.guarded_violations

    def reset(self) -> None:
        self._start = concurrency_counters()


class LockOrderWatchdog:
    """Context manager arming the concurrency sanitizer.

    While active: lock-order violations *raise* (instead of only
    counting), :func:`note_guarded` records eraser locksets, and every
    :class:`TrackedLock` acquisition is appended to a bounded trace —
    ``trace()`` returns this scope's (thread id, lock name) sequence,
    i.e. the per-thread acquisition stacks flattened in real order.
    """

    def __init__(self) -> None:
        self.events: Optional[ConcurrencyEvents] = None
        self._cut = 0

    def __enter__(self) -> "LockOrderWatchdog":
        global _watchdog_depth
        with _cc_lock:
            _watchdog_depth += 1
        self._cut = _WATCHDOG_TRACE.cut()
        self.events = ConcurrencyEvents()
        return self

    def __exit__(self, *exc) -> None:
        global _watchdog_depth
        with _cc_lock:
            _watchdog_depth -= 1
            if _watchdog_depth == 0:
                _eraser_state.clear()
        return None

    def trace(self) -> List[Tuple[int, str]]:
        return _WATCHDOG_TRACE.snapshot()[self._cut:]

    def stacks(self) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for tid, name in self.trace():
            out.setdefault(tid, []).append(name)
        return out
