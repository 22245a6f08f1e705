"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

The window drives the port's own entry, ``QuakeIndex.search_batch``, in a
closed loop of batches.  Everything timed is taken on the host clock by
this file; the program's counters and the profiler trace feed only the
per-layer metrics of a traced run."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import data as qdata
from . import devtrace, reference, spec, traffic, yardstick

KERNEL_LIBS = ("scan_topk", "scan_topk_indexed", "kmeans_assign")
JUDGE_BLOCK = 1024          # queries a reference block


@dataclass
class Ctx:
    """What the per-layer readers read."""
    k: int
    peaks: Dict[str, float]
    batches: List[dict] = field(default_factory=list)
    trace: Optional[dict] = None
    captures: Dict[str, List[dict]] = field(default_factory=dict)
    rooflines: Dict[str, object] = field(default_factory=dict)

    def roofline(self, kernel: str) -> Optional[float]:
        mod = self.rooflines.get(kernel)
        recs = self.captures.get(kernel)
        if mod is None or not recs or not self.trace:
            return None
        device_s = sum(v for name, v in self.trace["by_name"].items()
                       if mod.matches(name))
        return yardstick.roofline_share(
            (mod.work(r, self.k) for r in recs), device_s, self.peaks)


def _build_index(cfg: dict, x_host: np.ndarray, dev: torch.device):
    from repro_torch.core import QuakeConfig, QuakeIndex
    config = QuakeConfig(metric=cfg["metric"],
                         recall_target=float(cfg["index"]["recall_target"]))
    return QuakeIndex.build(x_host, num_partitions=int(
        cfg["index"]["num_partitions"]), config=config, device=dev)


def resident_checks(index, rows_host: np.ndarray) -> Dict[str, int]:
    """The index's resident set and stored rows against every row the
    harness made (ids 0..N-1, row i = ``rows_host[i]``)."""
    lvl0 = index.levels[0]
    ids = np.concatenate([np.asarray(i, dtype=np.int64) for i in lvl0.ids])
    vecs = np.concatenate([np.asarray(v) for v in lvl0.vectors])
    n = rows_host.shape[0]
    uniq = np.unique(ids)
    inside = uniq[(uniq >= 0) & (uniq < n)]
    resident_diff = (len(ids) - len(uniq)) + (len(uniq) - len(inside)) \
        + (n - len(inside))
    ok = (ids >= 0) & (ids < n)
    stored = int(np.any(vecs[ok] != rows_host[ids[ok]], axis=1).sum()) \
        + int((~ok).sum())
    return {"resident_diff": int(resident_diff), "stored_rows_diff": stored}


class BatchLoop:
    """Closed loop of batches through ``QuakeIndex.search_batch``."""

    def __init__(self, cell, seed, dev):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.cfg, self.tr = cell.config, cell.traffic
        self.k = int(self.cfg["k"])
        self.search = dict(self.tr["search"])
        self.search["storage_dtype"] = self.cfg["index"]["storage_dtype"]

    def setup(self, x, x_host):
        self.x = x
        self.rows_host = x_host
        self.work = traffic.batch_work(self.tr, self.cfg, x, self.seed)
        self.index = _build_index(self.cfg, x_host, self.dev)
        for i in range(self.work.warm):
            self.index.search_batch(self.work.pool[i % len(self.work.pool)],
                                    self.k, **self.search)

    def window(self, seconds, ctx: Ctx, win):
        pool = self.work.pool
        self.answers = []
        t0 = time.perf_counter()
        n = 0
        while True:
            j = n % len(pool)
            r = self.index.search_batch(pool[j], self.k, **self.search)
            self.answers.append((j, r.ids, r.dists))
            ctx.batches.append({"rounds": int(r.rounds),
                                "comparisons": int(r.comparisons),
                                "size": int(pool.shape[1])})
            n += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
            win.at(elapsed)
        self.elapsed = time.perf_counter() - t0
        self.n_queries = n * pool.shape[1]
        return {"qps": self.n_queries / self.elapsed}

    def state_checks(self):
        return resident_checks(self.index, self.rows_host)

    def release(self):
        self.index = None

    def notes(self):
        return {"window_s": self.elapsed, "batches": len(self.answers),
                "judged_batches": len(self.judged())}

    def attempted(self):
        return self.n_queries, 0

    def judged(self) -> np.ndarray:
        """The sent batches the reference judges: all of them, or
        ``judge_batches`` of them drawn from the seed."""
        sent = len(self.answers)
        most = int(self.tr.get("judge_batches", sent))
        if sent <= most:
            return np.arange(sent)
        rng = np.random.default_rng([int(self.seed) % (1 << 63), 11])
        return np.sort(rng.choice(sent, most, replace=False))

    def judge(self, control: bool):
        b = self.work.pool.shape[1]
        # every batch sent: a row missing or all misses is unanswered
        unanswered = sum(b - len(ids) + int((ids < 0).all(1).sum())
                         for _, ids, _ in self.answers)
        pick = self.judged()
        js = [self.answers[i][0] for i in pick]
        queries = torch.as_tensor(
            self.work.pool[js].reshape(-1, self.x.shape[1]), device=self.dev)
        _, want = reference.exact_topk(queries, self.x, self.k,
                                       block=JUDGE_BLOCK)
        if control:
            cd, ci = reference.exact_topk(queries, self.x, self.k,
                                          tf32=True, block=JUDGE_BLOCK)
            answers = [(ci[n * b:(n + 1) * b], cd[n * b:(n + 1) * b])
                       for n in range(len(pick))]
            unanswered = 0
        else:
            answers = [self.answers[i][1:] for i in pick]
        sums = {"dist_gap": 0.0, "bad_ids": 0, "unsorted": 0,
                "unanswered": unanswered}
        rec = 0.0
        for n, (ids, dists) in enumerate(answers):
            ids = torch.as_tensor(ids, device=self.dev)
            dists = torch.as_tensor(dists, device=self.dev)
            m = ids.shape[0]
            s = reference.judge(ids, dists, queries[n * b:n * b + m],
                                self.x, want[n * b:n * b + m])
            sums["dist_gap"] = max(sums["dist_gap"], float(s["dist_gap"]))
            sums["bad_ids"] += int(s["bad_ids"])
            sums["unsorted"] += int(s["unsorted"])
            rec += float(s["recall"])
        return sums, rec / max(len(pick) * b, 1)


def load_kernels(dev: torch.device) -> None:
    if dev.type != "cuda":
        return
    from repro_torch.kernels import build
    build.build_all(KERNEL_LIBS)
    for name in KERNEL_LIBS:
        build.lib(name)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             control: bool = False) -> dict:
    """One run of ``cell``: the result line as a dict, ``checks`` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_kernels(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = "cpu"
    cfg, tr = cell.config, cell.traffic
    if tr["loop"] != "batch":
        raise ValueError(f"unknown loop {tr['loop']!r}")
    mix = qdata.from_config(cfg, dev)
    x, _ = qdata.base_rows(cfg, mix, dev)
    drv = BatchLoop(cell, seed, dev)
    drv.setup(x, x.cpu().numpy())
    if trace:
        devtrace.warm_profiler()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    ctx = Ctx(k=int(cfg["k"]), peaks=yardstick.peaks_for(kind))
    kernels = spec.roofline_kernels(cell.per_layer)
    with devtrace.Window(trace, seconds, kernels) as win:
        e2e = drv.window(seconds, ctx, win)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0
    checks = drv.state_checks()
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged, recall = drv.judge(control)
    checks.update(judged)
    e2e["recall_at_k"] = recall
    e2e["setup_s"] = setup_s

    ctx.trace, ctx.captures, ctx.rooflines = (win.trace, win.captures,
                                              win.rooflines)
    e2e = {k: v for k, v in e2e.items() if np.isfinite(v)}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None and np.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    attempted, failed = drv.attempted()
    compared = {name: {"value": checks[name], "limit": cell.limits[name]}
                for name in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device_info}
    if trace and win.trace is not None:
        device_info["busy_s"] = win.trace["busy_s"]
        device_info["window_s"] = win.trace["window_s"]
        out["breakdown"] = {"device_ops": devtrace.top(win.trace["by_name"]),
                            "idle_gaps": devtrace.top(win.trace["idle"])}
    notes = drv.notes()
    notes.update({"seed": seed, "control": control,
                  "data_sum": float(x.double().sum()), "e2e": e2e})
    out["notes"] = _finite(notes)
    out["checks"] = compared
    return out


def _finite(v):
    """The notes with every non-finite number as None (strict JSON)."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v
