"""End-to-end Quake serving driver on the PyTorch port.

Replays a dynamic, skewed workload (Wikipedia-like by default) against the
**online serving runtime** (``core/serving.py``): queries flow through the
micro-batching queue into cross-batch riding probe rounds over the batched
executor, repeated queries can hit the journal-invalidated result cache,
and maintenance runs when a drift trigger fires instead of after every
operation — the full online system of paper §3.  Reports per-op latency /
recall, riding and cache telemetry, and the maintenance history.

    PYTHONPATH=src python -m repro_torch.launch.serve --months 8 --n 30000
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --n 3000 --months 2 --queries-per-month 64 --wal-dir /tmp/wal
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --recover --wal-dir /tmp/wal

The index and every round's scan live on ``--device`` (default ``cuda``,
which raises when CUDA is absent; ``--device cpu`` runs the kernels'
plain versions).  ``--per-op`` replays the one-search-at-a-time /
maintain-every-op loop instead.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..core import (LatencyModel, Maintainer, QuakeConfig, QuakeIndex,
                    ServingConfig, ServingRuntime, resolve_device)
from ..data import wikipedia
from ..data.workload import IncrementalGroundTruth
from ..faults import FaultInjector
from ..obs import summarize, to_prometheus


def parse_fault_spec(spec: str, seed: int = 0) -> FaultInjector:
    """``site=rate[,site=rate...]`` -> a seeded injector, e.g.
    ``--faults scan=0.05,maintenance=1.0`` (sites: see FaultInjector)."""
    rates = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, rate = part.partition("=")
        rates[site.strip()] = float(rate)
    return FaultInjector(seed=seed, rates=rates)


def _recall_rows(ids_rows, gt: np.ndarray, k: int) -> list:
    return [len(set(np.asarray(ids).tolist()) & set(gt[i].tolist())) / k
            for i, ids in enumerate(ids_rows)]


def _recall(ids_rows, gt: np.ndarray, k: int) -> float:
    return float(np.mean(_recall_rows(ids_rows, gt, k)))


def dump_metrics(rt: ServingRuntime, path: str) -> None:
    """Write the unified metrics snapshot as JSON plus a sibling
    ``<path>.prom`` in Prometheus text exposition format."""
    flat = rt.metrics_snapshot()
    with open(path, "w") as f:
        json.dump(flat, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(path + ".prom", "w") as f:
        f.write(to_prometheus(flat))


def _warm_runtime(index, wl, scfg: ServingConfig) -> None:
    """Warm the runtime's path before timing: a shadow runtime (no cache,
    no stats feedback, no maintenance) serves the first query op once,
    so the kernel libraries are loaded and the allocator's pools sized
    before the timed runtime starts.  The index is not mutated (queries
    only) and the shadow keeps its own planner cache, so the timed replay
    is unaffected."""
    import dataclasses
    qops = [op for op in wl.operations if op.kind == "query"]
    if not qops:
        return
    shadow_cfg = dataclasses.replace(
        scfg, cache_entries=0, record_stats=False,
        maint_min_ops=10 ** 9, maint_max_ops=None)
    shadow = ServingRuntime(index, shadow_cfg)
    try:
        shadow.submit_batch(qops[0].queries)
        shadow.drain()
    finally:
        shadow.close()


def _stall_s(rt: ServingRuntime) -> float:
    """Seconds the runtime has spent in maintenance passes and in
    checkpoints since it started."""
    s = float(sum(rt.maintenance.snapshot()["pass_s"]))
    if rt.durability is not None:
        s += rt.durability.stats()["checkpoint_s"]
    return s


def replay_runtime(wl, cfg: QuakeConfig, scfg: ServingConfig,
                   verbose: bool = True, warm: bool = False,
                   settle: bool = False,
                   faults: FaultInjector | None = None,
                   metrics_out: str | None = None,
                   trace_out: str | None = None,
                   metrics_every: int = 16, device="cuda",
                   gt_device=None) -> dict:
    """Replay a workload through the serving runtime on ``device``;
    returns the summary dict (wall-clock excludes ground truth;
    ``warm=True`` serves one query op on a shadow runtime first, so the
    measurement is steady-state serving; ``settle=True`` runs one
    maintenance pass right after the build, before serving starts —
    fresh k-means builds leave oversized partitions that the paper's
    system would split immediately).  ``gt_device`` computes the
    incremental ground truth there (a yardstick, not the path).  The
    summary also carries per-query-op recall (``recalls``), the
    per-query latencies (``latencies_s``), the seconds spent in query ops
    (``query_s``) and, of those, the seconds of the maintenance passes
    and checkpoints that ran inside them (``query_maintenance_s``), the
    runtime's final ``stats``, and the closed runtime and its index
    (``runtime``, ``index``)."""
    k = scfg.k
    t0 = time.perf_counter()
    index = QuakeIndex.build(wl.initial_vectors, wl.initial_ids, config=cfg,
                             device=device)
    maintainer = Maintainer(index, LatencyModel(dim=index.dim))
    if settle:
        maintainer.run()
    if warm:
        _warm_runtime(index, wl, scfg)
    rt = ServingRuntime(index, scfg, maintainer=maintainer, faults=faults)
    if verbose:
        print(f"built: {index.num_vectors} vectors, "
              f"{index.num_partitions} partitions "
              f"({time.perf_counter() - t0:.1f}s)")

    gt_inc = IncrementalGroundTruth(wl.dataset, wl.initial_ids,
                                    device=gt_device)
    recalls, latencies = [], []
    serve_s = query_s = query_maint_s = 0.0
    n_queries = 0
    for t, op in enumerate(wl.operations):
        if op.kind == "insert":
            t0 = time.perf_counter()
            rt.submit_insert(op.vectors, op.ids)
            dt = time.perf_counter() - t0
            serve_s += dt
            gt_inc.insert(op.ids)
            if verbose:
                print(f"[{t:3d}] insert {len(op.ids):6d}  {dt*1e3:7.1f}ms")
        elif op.kind == "delete":
            t0 = time.perf_counter()
            rt.submit_delete(op.ids)
            dt = time.perf_counter() - t0
            serve_s += dt
            gt_inc.delete(op.ids)
            if verbose:
                print(f"[{t:3d}] delete {len(op.ids):6d}  {dt*1e3:7.1f}ms")
        else:
            q = op.queries
            gt = gt_inc.topk(q, k)
            stall0 = _stall_s(rt)
            t0 = time.perf_counter()
            qids = rt.submit_batch(q)
            rt.drain()
            dt = time.perf_counter() - t0
            serve_s += dt
            query_s += dt
            query_maint_s += _stall_s(rt) - stall0
            n_queries += len(q)
            res = [rt.result(i) for i in qids]
            per_q = _recall_rows([r.ids for r in res], gt, k)
            rec = float(np.mean(per_q))
            recalls.append(rec)
            latencies.extend(r.latency_s for r in res)
            if rt.obs is not None:
                # calibration telemetry: the runtime's APS-style recall
                # estimate vs incremental-ground-truth recall, per query
                for r, true_rec in zip(res, per_q):
                    if np.isfinite(r.recall_estimate):
                        rt.obs.calibration.record_recall(
                            r.recall_estimate, true_rec)
            if verbose:
                hits = sum(r.from_cache for r in res)
                print(f"[{t:3d}] query  {len(q):6d}  "
                      f"{dt/len(q)*1e6:7.0f}us/q  recall={rec:.3f}  "
                      f"cache={hits}/{len(q)}  "
                      f"parts={index.num_partitions}")
        if metrics_out and (t + 1) % max(metrics_every, 1) == 0:
            dump_metrics(rt, metrics_out)   # periodic exposition flush
    rt.drain()
    st = rt.stats()
    if metrics_out:
        dump_metrics(rt, metrics_out)
    if trace_out and rt.obs is not None:
        rt.obs.tracer.dump_jsonl(trace_out)
    cal = None
    if rt.obs is not None:
        cal = {"latency_rel_err": rt.obs.calibration.latency_error(),
               "recall_abs_err": rt.obs.calibration.recall_error()}
    rt.close()                    # join the deadline ticker, if configured
    lat = summarize(latencies)    # the repo-wide shared percentile path
    out = {"mode": "runtime", "serve_s": round(serve_s, 3),
           "n_queries": n_queries,
           "qps": round(n_queries / max(serve_s, 1e-9), 1),
           "mean_recall": round(float(np.mean(recalls)), 4)
           if recalls else None,
           "p50_latency_us": round(lat["p50"] * 1e6, 1),
           "p99_latency_us": round(lat["p99"] * 1e6, 1),
           "final_partitions": index.num_partitions,
           "maintenance_runs": st["maintenance_runs"],
           "maintenance_reasons": st["maintenance_reasons"],
           "cache_hits": st["cache_hits"],
           "riding_savings": st["riding_savings"],
           "rounds_run": st["rounds_run"],
           "status_counts": dict(st["status_counts"]),
           "queries_shed": st["queries_shed"],
           "query_s": query_s, "query_maintenance_s": query_maint_s,
           "recalls": recalls, "latencies_s": latencies, "stats": st,
           "runtime": rt, "index": index}
    if cal is not None:
        out["calibration"] = cal
    if faults is not None or st["maintenance_failures"] or \
            st["cache_disabled"] or st["ticker_errors"]:
        out["failure_telemetry"] = {
            "scan_faults": st["scan_faults"],
            "scan_retries_used": st["scan_retries_used"],
            "failed_batches": st["failed_batches"],
            "maintenance_failures": st["maintenance_failures"],
            "cache_errors": st["cache_errors"],
            "cache_disabled": st["cache_disabled"],
            "ticker_errors": st["ticker_errors"],
            "ticker_restarts": st["ticker_restarts"],
            "governor": st["governor"]}
    if verbose:
        print(f"done. qps={out['qps']} recall={out['mean_recall']} "
              f"p99={out['p99_latency_us']}us maint={st['maintenance_runs']} "
              f"({','.join(st['maintenance_reasons']) or 'none'}) "
              f"cache_hits={st['cache_hits']} "
              f"riding_savings={st['riding_savings']} "
              f"statuses={dict(st['status_counts'])}")
        if cal is not None:
            print(f"calibration: latency_rel_err={cal['latency_rel_err']} "
                  f"recall_abs_err={cal['recall_abs_err']}")
        if "failure_telemetry" in out:
            print(f"failure telemetry: {out['failure_telemetry']}")
    return out


def replay_per_op(wl, cfg: QuakeConfig, k: int, verbose: bool = True,
                  maint_every_op: bool = True,
                  settle: bool = False, device="cuda") -> dict:
    """The per-op loop: one ``index.search`` per query (with the
    configured recall target threaded through) and a full maintenance
    pass after every operation."""
    t0 = time.perf_counter()
    index = QuakeIndex.build(wl.initial_vectors, wl.initial_ids, config=cfg,
                             device=device)
    maintainer = Maintainer(index, LatencyModel(dim=index.dim))
    if settle:
        maintainer.run()
    if verbose:
        print(f"built: {index.num_vectors} vectors, "
              f"{index.num_partitions} partitions "
              f"({time.perf_counter() - t0:.1f}s)")
    gt_inc = IncrementalGroundTruth(wl.dataset, wl.initial_ids)
    recalls, latencies = [], []
    serve_s = 0.0
    n_queries = 0
    for t, op in enumerate(wl.operations):
        if op.kind == "insert":
            t0 = time.perf_counter()
            index.insert(op.vectors, op.ids)
            serve_s += time.perf_counter() - t0
            gt_inc.insert(op.ids)
        elif op.kind == "delete":
            t0 = time.perf_counter()
            index.delete(op.ids)
            serve_s += time.perf_counter() - t0
            gt_inc.delete(op.ids)
        else:
            q = op.queries
            gt = gt_inc.topk(q, k)
            t0 = time.perf_counter()
            rows = []
            for i in range(len(q)):
                tq = time.perf_counter()
                r = index.search(q[i], k,
                                 recall_target=cfg.recall_target)
                latencies.append(time.perf_counter() - tq)
                rows.append(r.ids)
            dt = time.perf_counter() - t0
            serve_s += dt
            n_queries += len(q)
            rec = _recall(rows, gt, k)
            recalls.append(rec)
            if verbose:
                print(f"[{t:3d}] query  {len(q):6d}  "
                      f"{dt/len(q)*1e6:7.0f}us/q  recall={rec:.3f}")
        if maint_every_op:
            t0 = time.perf_counter()
            maintainer.run()
            serve_s += time.perf_counter() - t0
    lat = summarize(latencies)    # the repo-wide shared percentile path
    out = {"mode": "per_op", "serve_s": round(serve_s, 3),
           "n_queries": n_queries,
           "qps": round(n_queries / max(serve_s, 1e-9), 1),
           "mean_recall": round(float(np.mean(recalls)), 4)
           if recalls else None,
           "p50_latency_us": round(lat["p50"] * 1e6, 1),
           "p99_latency_us": round(lat["p99"] * 1e6, 1),
           "final_partitions": index.num_partitions}
    if verbose:
        print(f"done. qps={out['qps']} recall={out['mean_recall']} "
              f"p99={out['p99_latency_us']}us")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--months", type=int, default=8)
    ap.add_argument("--queries-per-month", type=int, default=500)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--recall-target", type=float, default=0.9)
    ap.add_argument("--rounds", type=int, default=None,
                    help="probe-round budget per query plan")
    ap.add_argument("--flush-size", type=int, default=64)
    ap.add_argument("--cache-entries", type=int, default=4096)
    ap.add_argument("--cache-bits", type=int, default=0)
    ap.add_argument("--cache-tol", type=float, default=0.0)
    ap.add_argument("--early-exit", action="store_true")
    ap.add_argument("--no-maintenance", action="store_true")
    ap.add_argument("--per-op", action="store_true",
                    help="per-op replay (maintain after every op)")
    ap.add_argument("--device", default="cuda",
                    help="device of the index and its scans (default "
                         "cuda, which raises without CUDA; cpu runs the "
                         "kernels' plain versions)")
    # failure semantics (docs/serving.md): budgets, admission control,
    # degradation governor, fault injection
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-query latency budget; expired queries "
                         "retire PARTIAL with their running top-k")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue (default unbounded)")
    ap.add_argument("--queue-policy", default="block",
                    choices=["block", "shed-oldest", "shed-newest"])
    ap.add_argument("--govern", action="store_true",
                    help="enable the degradation governor (lower the "
                         "effective recall target under queue pressure)")
    ap.add_argument("--faults", default=None, metavar="SITE=RATE[,..]",
                    help="inject seeded faults, e.g. "
                         "scan=0.05,maintenance=1.0,cache=1.0")
    ap.add_argument("--fault-seed", type=int, default=0)
    # crash-consistent durability (docs/durability.md)
    ap.add_argument("--wal-dir", default=None,
                    help="durability root: write-ahead log + checkpoints "
                         "(off by default)")
    ap.add_argument("--fsync", default="batch",
                    choices=["always", "batch", "off"],
                    help="WAL fsync policy (default batch)")
    ap.add_argument("--recover", action="store_true",
                    help="recover the index from --wal-dir (newest valid "
                         "checkpoint + WAL replay), print the recovery "
                         "report, and exit")
    # observability exposition (docs/observability.md)
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the unified metrics snapshot as JSON to "
                         "PATH (plus PATH.prom in Prometheus text "
                         "format), refreshed periodically during the "
                         "replay and once at the end")
    ap.add_argument("--metrics-every", type=int, default=16,
                    help="refresh --metrics-out every N workload ops")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="dump the query-trace ring buffer as JSON-lines")
    ap.add_argument("--no-metrics", action="store_true",
                    help="disable the metrics registry / tracer / "
                         "calibration tracker entirely")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.recover:
        if args.wal_dir is None:
            ap.error("--recover requires --wal-dir")
        rt = ServingRuntime.recover(
            args.wal_dir, ServingConfig(k=args.k, fsync=args.fsync),
            device=device)
        rep = rt.recovery_report
        print(f"recovered {rt.index.num_vectors} vectors / "
              f"{rt.index.num_partitions} partitions from {rep.root}")
        print(f"  checkpoint generation {rep.generation} "
              f"(wal_lsn={rep.ckpt_wal_lsn})")
        print(f"  wal: last_lsn={rep.wal_last_lsn} tail={rep.wal_reason} "
              f"truncated={rep.wal_truncated_bytes}B")
        print(f"  replayed {rep.records_replayed} records "
              f"({rep.inserts_replayed} inserts, "
              f"{rep.deletes_replayed} deletes, "
              f"{rep.fingerprint_checks} fingerprint checks)")
        print(f"  write ops recovered: {rep.write_ops_recovered}")
        print(f"  fingerprint: {rep.fingerprint}")
        rt.close()
        return

    wl = wikipedia.wikipedia_workload(
        n_total=args.n, dim=args.dim, months=args.months,
        queries_per_month=args.queries_per_month)
    cfg = QuakeConfig(metric="ip", recall_target=args.recall_target)
    if args.per_op:
        replay_per_op(wl, cfg, args.k,
                      maint_every_op=not args.no_maintenance, device=device)
        return
    scfg = ServingConfig(
        k=args.k, recall_target=args.recall_target, rounds=args.rounds,
        early_exit=args.early_exit, flush_size=args.flush_size,
        cache_entries=args.cache_entries, cache_bits=args.cache_bits,
        cache_tol=args.cache_tol,
        deadline_s=args.deadline_s, queue_cap=args.queue_cap,
        queue_policy=args.queue_policy, govern=args.govern,
        wal_dir=args.wal_dir, fsync=args.fsync,
        metrics=not args.no_metrics)
    if args.no_maintenance:
        scfg.maint_min_ops = 10 ** 9      # triggers never reach min_ops
        scfg.maint_max_ops = None
    faults = (parse_fault_spec(args.faults, seed=args.fault_seed)
              if args.faults else None)
    replay_runtime(wl, cfg, scfg, faults=faults,
                   metrics_out=args.metrics_out, trace_out=args.trace_out,
                   metrics_every=args.metrics_every, device=device,
                   gt_device=device)


if __name__ == "__main__":
    main()
