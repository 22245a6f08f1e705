#!/usr/bin/env python3
"""APS recall and probe counts of the port and the JAX package, per data
mixture.

    PYTHONPATH=src python scripts/aps_mixtures.py --side both --device cpu \
        --n 100000 --batch 256 --mixture 64:1.2 --mixture 1638:0.5
    python scripts/aps_mixtures.py --side torch --device cuda \
        --n 1000000 --batch 1024 --mixture 64:1.2 --mixture 16384:0.5

For each mixture ``C:POWER`` (``datasets.clustered`` with C Gaussian
clusters of sizes proportional to i^-POWER, seed ``--seed``), it builds an
index with P = sqrt(n) partitions and runs ``search_batch`` on queries
near data points, at k=100 with recall target 0.9 (APS) and at
``nprobe=32, rounds=1``, and reports recall@k against exact ground truth,
mean nprobe and rounds:

  * ``--side torch``: the port (``repro_torch``) on ``--device``;
  * ``--side jax``: the JAX package on the CPU (its jnp path);
  * ``--side both``: both, and the port again on the JAX package's own
    index structure (``index_from_arrays``), so that any difference in
    probe counts is the planner's and not k-means drift.

``--side torch`` imports nothing of JAX.  The records go to ``--out``
(JSON) and one line per run to standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data import datasets  # noqa: E402


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", choices=("torch", "jax", "both"),
                    default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixture", action="append", default=None,
                    help="C:POWER, repeatable (default 64:1.2)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "aps_mixtures.json"))
    return ap.parse_args()


def recall_at(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
                          for a, b in zip(ids, gt)]))


def export_jax_index(idx) -> dict:
    """A JAX ``QuakeIndex`` as the plain-numpy state dict of
    ``repro_torch.core.convert``."""
    from repro.core.index import QuakeConfig as JConfig
    state = {"dim": idx.dim, "max_norm_sq": float(idx._max_norm_sq),
             "num_levels": len(idx.levels),
             "beta_table": np.asarray(idx._beta_table, np.float32)}
    for f in dataclasses.fields(JConfig):
        state[f"config.{f.name}"] = getattr(idx.config, f.name)
    for l, lv in enumerate(idx.levels):
        state[f"level{l}.centroids"] = np.asarray(lv.centroids)
        if l == 0:
            state["level0.sizes"] = lv.sizes()
            state["level0.vectors"] = np.concatenate(lv.vectors)
            state["level0.ids"] = np.concatenate(lv.ids)
            state["level0.sqnorms"] = np.concatenate(lv.sqnorms)
        else:
            state[f"level{l}.child_sizes"] = lv.sizes()
            state[f"level{l}.children"] = np.concatenate(lv.children)
        if lv.parent is not None:
            state[f"level{l}.parent"] = np.asarray(lv.parent)
    return state


def run_searches(label, idx, q, gt, k, search_kw, out):
    """APS at target 0.9 and a fixed nprobe=32 plan on one index."""
    for mode, kw in (("aps", dict(recall_target=0.9)),
                     ("nprobe32", dict(nprobe=32, rounds=1))):
        t = time.perf_counter()
        r = idx.search_batch(q, k, **kw, **search_kw)
        wall = time.perf_counter() - t
        rec = {"side": label, "mode": mode, "recall": recall_at(r.ids, gt),
               "mean_nprobe": float(np.mean(r.nprobe)),
               "rounds": int(r.rounds), "wall_s": wall,
               "nprobe": np.asarray(r.nprobe)}
        out.append(rec)
        print(f"  {label:14s} {mode:8s} recall@{k} {rec['recall']:.4f} "
              f"mean nprobe {rec['mean_nprobe']:.2f} rounds "
              f"{rec['rounds']} ({wall:.2f} s)", flush=True)


def main() -> int:
    args = parse_args()
    mixtures = args.mixture or ["64:1.2"]
    records = []
    for mix in mixtures:
        c, power = mix.split(":")
        c, power = int(c), float(power)
        ds = datasets.clustered(args.n, args.dim, n_clusters=c, power=power,
                                seed=args.seed)
        q = datasets.queries_near(ds, args.batch, seed=args.seed + 1)
        gt_dev = args.device if args.side == "torch" else None
        gt = ds.ground_truth(q, args.k, device=gt_dev)
        print(f"mixture {c} clusters, power {power}: n {args.n}, "
              f"d {args.dim}, B {args.batch}", flush=True)
        runs = []
        jax_index = None
        if args.side in ("jax", "both"):
            from repro.core.index import QuakeIndex as JIndex
            jax_index = JIndex.build(ds.vectors)
            run_searches("jax", jax_index, q, gt, args.k,
                         dict(impl="jnp"), runs)
        if args.side in ("torch", "both"):
            from repro_torch.core.index import QuakeIndex
            idx = QuakeIndex.build(ds.vectors, device=args.device)
            run_searches("torch", idx, q, gt, args.k, {}, runs)
            del idx
        if jax_index is not None and args.side == "both":
            from repro_torch.core.convert import index_from_arrays
            idx = index_from_arrays(export_jax_index(jax_index),
                                    device=args.device)
            run_searches("torch_on_jax", idx, q, gt, args.k, {}, runs)
            for mode in ("aps", "nprobe32"):
                a = [r for r in runs if r["mode"] == mode]
                ref = next(r for r in a if r["side"] == "jax")
                same = next(r for r in a if r["side"] == "torch_on_jax")
                eq = bool(np.array_equal(ref["nprobe"], same["nprobe"]))
                print(f"  {mode}: per-query nprobe of the port on the JAX "
                      f"structure equals the JAX package's: {eq}")
                same["nprobe_equals_jax"] = eq
        for r in runs:
            r["nprobe"] = r["nprobe"].tolist()
        records.append({"clusters": c, "power": power, "n": args.n,
                        "dim": args.dim, "batch": args.batch, "k": args.k,
                        "seed": args.seed, "device": args.device,
                        "runs": runs})
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records))
    print(f"records written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
