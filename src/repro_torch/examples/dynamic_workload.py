"""Dynamic skewed workload: Quake vs a static IVF baseline (paper Fig. 4).

    PYTHONPATH=src python -m repro_torch.examples.dynamic_workload \
        [--device cpu]

Replays a scaled Wikipedia-12M analogue (monthly insert bursts with topic
drift, Zipf-popular queries, inner-product metric) through

  * quake  : APS at a 0.9 recall target + cost-model maintenance,
  * static : fixed nprobe tuned once on month 0, no maintenance
             (the Faiss-IVF row of paper Table 3 / Figure 4),

and prints the month-by-month latency / recall / partition-count trace
(the JAX package's ``examples/dynamic_workload.py``, on the card unless
``--device cpu``).  The static index's recall decays as the data grows
and drifts; Quake holds the target with stable latency.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import LatencyModel, Maintainer, QuakeConfig, QuakeIndex
from ..data.wikipedia import wikipedia_workload

EVAL_QUERIES = 60            # of each query operation, held against exact


def run_method(method: str, wl, k: int = 10, target: float = 0.9,
               device="cuda") -> list:
    """One method over the workload: a row per query operation (month,
    vectors, partitions, recall, us a query, nprobe, vectors scanned)."""
    ds = wl.dataset
    cfg = QuakeConfig(metric=ds.metric, enable_aps=(method == "quake"),
                      recall_target=target, fixed_nprobe=24)
    idx = QuakeIndex.build(wl.initial_vectors, wl.initial_ids, config=cfg,
                           kmeans_iters=5, device=device)
    maint = Maintainer(idx, LatencyModel(dim=ds.dim)) \
        if method == "quake" else None

    resident = {int(i) for i in wl.initial_ids}
    print(f"\n== {method} ==")
    print(f"{'op':>4} {'n_vec':>7} {'parts':>6} {'recall':>7} "
          f"{'us/query':>9} {'nprobe':>7} {'scanned':>8}")
    month, rows = 0, []
    for op in wl.operations:
        if op.kind == "insert":
            idx.insert(op.vectors, op.ids)
            resident.update(int(i) for i in op.ids)
            month += 1
        elif op.kind == "delete":
            idx.delete(op.ids)
            resident.difference_update(int(i) for i in op.ids)
        else:
            res = np.asarray(sorted(resident))
            x = ds.vectors[res]
            qs = op.queries[:EVAL_QUERIES]
            d = -(qs @ x.T)                      # inner-product metric
            gt = res[np.argpartition(d, k - 1, axis=1)[:, :k]]
            t0 = time.perf_counter()
            recs, nps, scanned = [], [], []
            for i, q in enumerate(qs):
                r = idx.search(q, k, recall_target=target)
                recs.append(
                    len(set(r.ids.tolist()) & set(gt[i].tolist())) / k)
                nps.append(r.nprobe[0])
                scanned.append(r.vectors_scanned)
            dt = (time.perf_counter() - t0) / len(qs) * 1e6
            row = {"month": month, "n_vec": idx.num_vectors,
                   "parts": idx.levels[0].num_partitions,
                   "recall": float(np.mean(recs)), "us_per_query": dt,
                   "nprobe": float(np.mean(nps)),
                   "scanned": float(np.mean(scanned))}
            rows.append(row)
            print(f"{month:>4} {row['n_vec']:>7} {row['parts']:>6} "
                  f"{row['recall']:>7.3f} {dt:>9.0f} {row['nprobe']:>7.1f} "
                  f"{row['scanned']:>8.0f}")
            if maint is not None:
                maint.run()
    return rows


def run(n_total: int = 24_000, dim: int = 32, months: int = 8,
        queries_per_month: int = 300, device="cuda") -> dict:
    """Both methods over one workload (the reference's sizes by default):
    {method: rows}."""
    wl = wikipedia_workload(n_total=n_total, dim=dim, months=months,
                            queries_per_month=queries_per_month, seed=0)
    return {m: run_method(m, wl, device=device) for m in ("static", "quake")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
