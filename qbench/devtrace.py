"""The traced run: ``torch.profiler`` over the window, host spans around the
calls into each layer of the port, the roofline kernels' calls recorded,
and the chrome trace reduced to busy time, kernel time by name and idle
gaps by what the host was doing.

Spans are recorded from here, by wrapping the port's functions for the
traced window only (``SPANS``); the untraced runs that give the
end-to-end metrics run the port unwrapped."""
from __future__ import annotations

import functools
import importlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import spec

WINDOW = "qbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# (module, attribute path): the port's layer boundaries a traced run spans
SPANS = (
    ("repro_torch.core.index", "QuakeIndex.search_batch"),
    ("repro_torch.core.multiquery", "plan_rounds"),
    ("repro_torch.core.multiquery", "plan_batch"),
    ("repro_torch.core.multiquery", "run_round_loop"),
    ("repro_torch.core.multiquery", "BatchedSearchExecutor.scan_probe_round"),
    ("repro_torch.core.multiquery", "BatchedSearchExecutor.refresh"),
)


def _resolve(mod_name: str, path: str):
    owner = importlib.import_module(mod_name)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Patches:
    """Wrappers installed for one window and taken out after it."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, mod_name: str, path: str, make):
        owner, attr = _resolve(mod_name, path)
        orig = owner.__dict__[attr] if isinstance(owner, type) \
            else getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def undo(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []


def _span(label):
    def make(fn):
        @functools.wraps(fn)
        def spanned(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return spanned
    return make


def _capture(mod, sink):
    def make(fn):
        @functools.wraps(fn)
        def captured(*a, **kw):
            sink.append(mod.record(*a, **kw))
            return fn(*a, **kw)
        return captured
    return make


TRACED_S = 10.0      # the steady sub-window a traced run profiles


class Window:
    """Context over the measured window.  Off: only the host clock.  On:
    spans, the calls of ``kernels`` (names of ``roofline/<kernel>.py``)
    and the profiler over the middle ``TRACED_S`` seconds of the window
    (all of a shorter one), reduced on exit.  The window's loop calls
    ``at(elapsed)`` between calls into the port."""

    def __init__(self, on: bool, seconds: float, kernels=()):
        self.on = on
        self.kernels = tuple(kernels)
        self.start_s = max(0.0, (seconds - TRACED_S) / 2)
        self._started = 0.0
        self.captures: Dict[str, List[dict]] = {}
        self.rooflines = {}
        self.trace: Optional[dict] = None
        self._patches = Patches()
        self._prof = None
        self._rf = None
        self._state = "before"

    def __enter__(self):
        self.at(0.0)
        return self

    def at(self, elapsed: float) -> None:
        if not self.on:
            return
        if self._state == "before" and elapsed >= self.start_s:
            self._start()
            self._started = time.perf_counter()
            self._state = "tracing"
        elif (self._state == "tracing"
              and time.perf_counter() - self._started >= TRACED_S):
            self._stop()
            self._state = "after"

    def __exit__(self, *exc):
        if self._state == "tracing":
            self._stop(reduce=exc[0] is None)
        self._state = "after"
        return False

    def _start(self):
        for mod_name, path in SPANS:
            self._patches.wrap(mod_name, path,
                               _span("qbench." + path.split(".")[-1]))
        for name in self.kernels:
            mod = spec.roofline_module(name)
            self.rooflines[name] = mod
            self.captures[name] = []
            self._patches.wrap(*mod.TARGET, _capture(mod,
                                                     self.captures[name]))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()

    def _stop(self, reduce: bool = True):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._patches.undo()
        if reduce:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.trace = reduce_events(json.load(f)["traceEvents"])
            finally:
                os.unlink(path)
        self._prof = None


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start in a
    process takes seconds (CUPTI), which would otherwise fall into the
    traced window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(8).sum()
        if torch.cuda.is_available():
            torch.ones(8, device="cuda").sum()
            torch.cuda.synchronize()


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict]) -> Optional[dict]:
    """Busy and window seconds, device seconds by op name, and idle
    seconds by the innermost ``qbench.`` host span open at each gap's
    middle (``host`` where none is), from chrome-trace events (µs)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("qbench.")
                   and e["name"] != WINDOW)
    idle: Dict[str, float] = {}
    active: List[tuple] = []
    nxt = 0
    for a, b in gaps:           # in time order: one sweep over the spans
        mid = 0.5 * (a + b)
        while nxt < len(spans) and spans[nxt][0] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [s for s in active if s[1] >= mid]
        # the innermost open span: the latest start among those open
        name = max(active)[2] if active else "host"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6, "by_name": by_name, "idle": idle}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
