#!/usr/bin/env python3
"""Both designs of the f32 indexed scan, timed on the card at the
benchmark cells' plans, for the crossover ``TILED_MIN_D`` (row width)
and ``TILED_MIN_B`` (queries a call) of ``scan_topk_indexed.design``.

    PYTHONPATH=src python scripts/scan_crossover.py          # on the card
    PYTHONPATH=src python scripts/scan_crossover.py --device cpu \\
        --rows 20000 --dims 16,64 --reps 1                   # rehearsal

The script builds the index of ``sift1m-l2`` and of
``dbpedia3072-1m-l2`` as ``qbench`` does (the same base rows, queries
from ``--seed``), searches one batch of each cell's traffic and keeps the
operands of every scan call the batch made: the APS rounds of
``sift1m-l2.aps-b1024`` and the one ``nprobe=32`` round of each other
cell.  Each plan keeps its union pages, their live rows and its query
mask; at every width of ``--dims`` it gets new rows and queries
(N(0, 1), f32) of that width in the same pages, and both designs scan
them: the row-per-thread design (``design`` patched to 0) and the
register-tiled one (patched to ``TILED``), in turns (rows, tiled, tiled,
rows), each time the median of ``--reps`` windows of CUDA events.
Serving shapes are the first ``--serving`` queries of the ``nprobe=32``
plans.
Every point also checks that the two designs agree (ids as sets to 0.99,
distances to 1e-4 relative).

The table goes to stdout and, with the card's name and power limit, to
``--out`` (JSON) when given.  On the CPU both "designs" are the plain
version: that only rehearses the control flow.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from qbench import data as qdata, harness, spec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scan_topk_indexed as sti  # noqa: E402

CELLS = (("sift1m-l2.aps-b1024", "sift_aps"),
         ("sift1m-l2.nprobe32-b1024", "sift_nprobe32"),
         ("dbpedia3072-1m-l2.nprobe32-b1024-p512", "wide_nprobe32"))


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    ap.add_argument("--rows", type=int, default=0,
                    help="rows of each index (0: the configuration's)")
    ap.add_argument("--dims", default="128,256,512,768,1024,1536,3072")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--serving", default="1,4,16",
                    help="queries of the serving shapes")
    ap.add_argument("--out", default=None)
    return ap.parse_args()


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(dev)


def capture(cell_name: str, args, dev):
    """The scan calls one batch of the cell makes, over the union of
    their pages: {"valid": (pages, S) live flags, "calls": [(sel into
    those pages, qmask, k_pad, metric)]}."""
    over = {"config": {"rows": args.rows}} if args.rows else None
    cell = spec.load_cell(cell_name, overrides=over)
    mix = qdata.from_config(cell.config, dev)
    x, _ = qdata.base_rows(cell.config, mix, dev)
    drv = harness.BatchLoop(cell, args.seed, dev)
    drv.setup(x, x.cpu().numpy())
    calls, valids = [], []
    real = ops.scan_selected_topk

    def record(queries, data, valid, sel, qmask, k, **kw):
        k_pad = ops._next_pow2(max(min(k, sel.shape[0] * data.shape[1]), 1))
        calls.append((sel.long().clone(), qmask.clone(), k_pad,
                      kw.get("metric", "l2")))
        valids.append(valid)
        return real(queries, data, valid, sel, qmask, k, **kw)
    ops.scan_selected_topk = record
    try:
        drv.index.search_batch(drv.work.pool[drv.work.warm], drv.k,
                               **drv.search)
    finally:
        ops.scan_selected_topk = real
    pages = torch.unique(torch.cat([c[0] for c in calls]))
    plan = {"valid": valids[0].index_select(0, pages).contiguous(),
            "calls": [(torch.searchsorted(pages, sel).to(torch.int32),
                       qmask, k_pad, metric)
                      for sel, qmask, k_pad, metric in calls]}
    del drv, x, valids
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return plan


def serving(plan, b: int):
    """The first b queries of a one-round plan, its union cut to the
    pages they probe."""
    sel, qmask, k_pad, metric = plan["calls"][0]
    qm = qmask[:b]
    cols = qm.any(0)
    return dict(plan, calls=[(sel[cols].contiguous(),
                              qm[:, cols].contiguous(), k_pad, metric)])


def operands(plan, d: int, dev, g):
    """New rows of width d in the plan's pages, and new queries."""
    pages, s = plan["valid"].shape
    data = torch.randn((pages, s, d), generator=g, device=dev)
    out = []
    for sel, qmask, k_pad, metric in plan["calls"]:
        q = torch.randn((qmask.shape[0], d), generator=g, device=dev)
        out.append((q, data, plan["valid"], sel, qmask, k_pad, metric))
    return out


def run(ops_, design: int):
    """Scan every call of a plan on one design (0 rows, ``TILED``)."""
    real = sti.design
    sti.design = lambda *a: design
    try:
        return [sti.scan_topk_indexed(q, data, valid, sel, qmask,
                                      k_pad=k_pad, metric=metric)
                for q, data, valid, sel, qmask, k_pad, metric in ops_]
    finally:
        sti.design = real


def window_ms(fn, dev, reps: int) -> float:
    """Median over ``reps`` windows of one call each (CUDA events; the
    host clock on the CPU), after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def agree(a, b) -> dict:
    """The two designs' results: worst relative distance difference over
    finite entries and the mean overlap of the id sets."""
    worst, over, n = 0.0, 0.0, 0
    for (da, ia), (db, ib) in zip(a, b):
        fin = db < 1e37
        if bool((da < 1e37).ne(fin).any()):
            return {"max_rel": float("inf"), "overlap": 0.0}
        if fin.any():
            rel = ((da[fin] - db[fin]).abs()
                   / db[fin].abs().clamp(min=1.0)).max()
            worst = max(worst, float(rel))
        ia_, ib_ = ia.cpu().numpy(), ib.cpu().numpy()
        for x, y in zip(ia_, ib_):
            ys = set(y[y >= 0].tolist())
            if ys:
                over += len(set(x[x >= 0].tolist()) & ys) / len(ys)
                n += 1
    return {"max_rel": worst, "overlap": over / max(n, 1)}


def point(name, plan, d, dev, g, reps):
    ops_ = operands(plan, d, dev, g)
    live = plan["valid"].sum(1)
    pairs = sum(int((qmask.long() * live[sel.long()][None]).sum())
                for sel, qmask, _, _ in plan["calls"])
    tiled = sti.TILED
    check = agree(run(ops_, 0), run(ops_, tiled))
    ms = {0: [], tiled: []}
    for design in (0, tiled, tiled, 0):
        ms[design].append(window_ms(lambda: run(ops_, design), dev, reps))
    rows_ms, tiled_ms = (statistics.mean(ms[0]), statistics.mean(ms[tiled]))
    flops = 2.0 * pairs * d
    per_page = [float(qm.sum(0)[qm.any(0)].float().mean())
                for _, qm, _, _ in plan["calls"]]
    row = {"plan": name, "d": d,
           "B": int(plan["calls"][0][1].shape[0]),
           "queries_a_page": statistics.mean(per_page),
           "calls": len(plan["calls"]), "pair_rows": pairs,
           "rows_ms": rows_ms, "tiled_ms": tiled_ms,
           "speedup": rows_ms / tiled_ms if tiled_ms else None,
           "rows_tflops": flops / rows_ms / 1e9,
           "tiled_tflops": flops / tiled_ms / 1e9, **check}
    print(f"{name:>17} d {d:5d} B {row['B']:5d}: rows "
          f"{rows_ms:9.3f} ms ({row['rows_tflops']:6.2f} TFLOP/s), tiled "
          f"{tiled_ms:9.3f} ms ({row['tiled_tflops']:6.2f}), x"
          f"{row['speedup']:.3f}; agree rel {check['max_rel']:.2e} "
          f"overlap {check['overlap']:.4f}", flush=True)
    del ops_
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main() -> int:
    args = parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    harness.load_kernels(dev)
    line = card_line(dev)
    print(f"card: {line}", flush=True)
    plans = {}
    for cell_name, name in CELLS:
        t0 = time.perf_counter()
        plans[name] = p = capture(cell_name, args, dev)
        print(f"{name}: {len(p['calls'])} scan calls over "
              f"{int(p['valid'].shape[0])} pages, queries a probed page "
              f"{[round(float(q.sum(0)[q.any(0)].float().mean()), 1) for _, q, _, _ in p['calls']]}"
              f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    dims = [int(v) for v in args.dims.split(",")]
    serving_b = [int(v) for v in args.serving.split(",") if v]
    table = []
    for d in dims:
        for name, plan in plans.items():
            table.append(point(name, plan, d, dev, g, args.reps))
        for b in serving_b:
            for name in ("sift_nprobe32", "wide_nprobe32"):
                table.append(point(f"{name}_b{b}", serving(plans[name], b),
                                   d, dev, g, args.reps))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": line, "seed": args.seed,
                                   "tiled_min_d": sti.TILED_MIN_D,
                                   "tiled_min_b": sti.TILED_MIN_B,
                                   "table": table}, indent=1))
    bad = [r for r in table if r["overlap"] < 0.99 or r["max_rel"] > 1e-4]
    if bad:
        print(f"FAIL: the designs disagree at {len(bad)} points",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
