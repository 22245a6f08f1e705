#!/usr/bin/env python3
"""The dynamic loop (paper Fig. 4) through the JAX package and the port,
side by side, on the CPU.

    PYTHONPATH=src python scripts/dynamic_replay.py --n 30000 --months 3 \
        --queries 128 --lam 0,176.2,0

The Wikipedia-style workload (``data/wikipedia.py``: inner product, topic
bursts, Zipf queries with a drifting hot set) at ``--n`` vectors.  One JAX
index is built and loaded into the port (``index_from_arrays``), and a
second JAX index is left unmaintained.  Per month (``replay``, which
``tests/test_torch_maintenance.py`` drives too): the insert burst into
all three, ``--queries`` per-query APS searches at target 0.9 on each
(recall@10 against exact ground truth; on the maintained indexes they
record the access statistics), then ``Maintainer.run()`` on the two
maintained ones with the latency model ``--lam c_fixed,c_lin,c_sel`` (ns)
and commit threshold ``--tau`` ns.  Each pass prints its splits, merges,
rejections and cost before and after, split into the priced part (the sum
of the committed actions' deltas, what the commit gate prices) and the
unpriced rest (refinement and level changes).  Records go to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from aps_mixtures import export_jax_index  # noqa: E402


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--months", type=int, default=3)
    ap.add_argument("--queries", type=int, default=128,
                    help="per-query searches per month")
    ap.add_argument("--lam", default=None,
                    help="c_fixed,c_lin,c_sel in ns (default: the "
                         "LatencyModel defaults)")
    ap.add_argument("--tau", type=float, default=None,
                    help="commit threshold in ns (default: QuakeConfig's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "dynamic_replay.json"))
    return ap.parse_args()


def pass_record(rep) -> dict:
    priced = sum(a["delta"] for a in rep.actions if a["committed"])
    return {"splits": rep.splits, "merges": rep.merges,
            "rejected": rep.rejected_splits + rep.rejected_merges,
            "cost_before": rep.cost_before, "cost_after": rep.cost_after,
            "priced": priced,
            "unpriced": rep.cost_after - rep.cost_before - priced}


def replay(wl, indexes: dict, maintainers: dict, k: int = 10):
    """The month loop over the workload ``wl``: each insert burst goes
    into every index; each month's queries run as per-query APS searches
    at target 0.9 on every index (recall@k against exact ground truth;
    they record the access statistics), then every maintainer runs one
    pass.  Yields one row per month, after its passes: per index its
    recall and partitions, and per maintained index its ``pass_record``."""
    from repro.data.workload import IncrementalGroundTruth
    gt = IncrementalGroundTruth(wl.dataset, wl.initial_ids)
    month = 0
    for op in wl.operations:
        if op.kind == "insert":
            for idx in indexes.values():
                idx.insert(op.vectors, op.ids)
            gt.insert(op.ids)
            continue
        month += 1
        truth = gt.topk(op.queries, k)
        row = {"month": month}
        for name, idx in indexes.items():
            hits = [len(set(idx.search(qq, k, recall_target=0.9).ids
                            .tolist()) & set(t.tolist())) / k
                    for qq, t in zip(op.queries, truth)]
            row[name] = {"recall": float(np.mean(hits))}
        for name, m in maintainers.items():
            row[name].update(pass_record(m.run()))
        for name, idx in indexes.items():
            row[name]["partitions"] = idx.num_partitions
        yield row


def main() -> int:
    args = parse_args()
    from repro.core import LatencyModel as JLatency
    from repro.core import Maintainer as JMaintainer
    from repro.core import QuakeConfig as JConfig
    from repro.core import QuakeIndex as JIndex
    from repro.data.wikipedia import wikipedia_workload
    from repro_torch.core import LatencyModel, Maintainer, index_from_arrays

    coefs = ([float(c) for c in args.lam.split(",")] if args.lam
             else None)
    wl = wikipedia_workload(n_total=args.n, dim=args.dim,
                            months=args.months,
                            queries_per_month=args.queries, seed=args.seed)
    cfg = {"metric": "ip"}
    if args.tau is not None:
        cfg["tau_ns"] = args.tau

    def build():
        return JIndex.build(wl.initial_vectors, wl.initial_ids,
                            config=JConfig(**cfg), kmeans_iters=10)

    jax_idx, still = build(), build()
    port_idx = index_from_arrays(export_jax_index(jax_idx), device="cpu")
    lams = ((JLatency(*coefs, args.dim), LatencyModel(*coefs, args.dim))
            if coefs else (JLatency(), LatencyModel()))
    maint = {"jax": JMaintainer(jax_idx, lams[0]),
             "port": Maintainer(port_idx, lams[1])}
    indexes = {"unmaintained": still, "jax": jax_idx, "port": port_idx}
    months = []
    print(f"n {args.n}, d {args.dim}, lambda {coefs or 'default'}, tau "
          f"{jax_idx.config.tau_ns} ns; {jax_idx.num_partitions} partitions")
    for row in replay(wl, indexes, maint):
        months.append(row)
        print(f"month {row['month']}: recall@10 unmaintained "
              f"{row['unmaintained']['recall']:.4f}", flush=True)
        for name in maint:
            r = row[name]
            print(f"  {name:5s} recall@10 {r['recall']:.4f}, partitions "
                  f"{r['partitions']}, splits {r['splits']}, merges "
                  f"{r['merges']}, rejected {r['rejected']}, cost "
                  f"{r['cost_before']:.4f} -> {r['cost_after']:.4f} "
                  f"(priced {r['priced']:+.4f}, unpriced "
                  f"{r['unpriced']:+.4f})", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"args": vars(args), "months": months}))
    print(f"records written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
