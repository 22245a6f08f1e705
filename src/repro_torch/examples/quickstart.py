"""Quickstart: build a Quake index, search with APS, update, maintain.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's whole loop on a clustered dataset (the JAX package's
``examples/quickstart.py``, on the card unless ``--device cpu``):
  1. build a partitioned index (k-means),
  2. search with Adaptive Partition Scanning at a recall target, no
     nprobe tuning,
  3. apply a skewed insert burst (the thing that wrecks static indexes),
  4. run cost-model maintenance (estimate -> verify -> commit/reject),
  5. show that the latency-proxy cost dropped and recall holds.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core import Maintainer, QuakeConfig, QuakeIndex
from ..data import datasets


def recall(ids, gt) -> float:
    return len(set(ids.tolist()) & set(gt.tolist())) / len(gt)


def run(n: int = 20_000, dim: int = 32, n_clusters: int = 64,
        n_queries: int = 100, n_burst: int = 4000, n_hot: int = 200,
        k: int = 10, target: float = 0.9, power: float = 1.2,
        device="cuda") -> dict:
    """The example's steps at its sizes (the reference's by default, the
    dataset's ``power`` too); returns the printed numbers, the index
    (``"index"``) and the dataset of all its vectors (``"dataset"``)."""
    rng = np.random.default_rng(0)
    ds = datasets.clustered(n, dim, n_clusters=n_clusters, power=power,
                            seed=0)
    out = {}

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    idx = QuakeIndex.build(ds.vectors, ids=np.arange(ds.n),
                           config=QuakeConfig(metric="l2"), device=device)
    out["build_s"] = time.perf_counter() - t0
    out["partitions"] = idx.levels[0].num_partitions
    print(f"built {idx.num_vectors} vectors -> {out['partitions']} "
          f"partitions in {out['build_s']:.2f}s")

    # 2. APS search at a recall target -------------------------------------
    q = datasets.queries_near(ds, n_queries, seed=1)
    gt = ds.ground_truth(q, k)
    recs, nprobes = [], []
    t0 = time.perf_counter()
    for i in range(len(q)):
        r = idx.search(q[i], k=k, recall_target=target)
        recs.append(recall(r.ids, gt[i]))
        nprobes.append(r.nprobe[0])
    dt = (time.perf_counter() - t0) / len(q)
    out.update(recall=float(np.mean(recs)), nprobe=float(np.mean(nprobes)),
               us_per_query=dt * 1e6)
    print(f"APS @ target {target}: recall={out['recall']:.3f} "
          f"mean nprobe={out['nprobe']:.1f} "
          f"latency={out['us_per_query']:.0f}us/query")

    # 3. skewed insert burst: everything lands in one region ---------------
    hot = ds.vectors[ds.cluster_of == 0]
    burst = hot[rng.integers(0, len(hot), n_burst)] + \
        rng.normal(scale=0.05, size=(n_burst, ds.dim)).astype(np.float32)
    idx.insert(burst, np.arange(ds.n, ds.n + n_burst))
    # queries now also hit the hot region (read skew)
    hot_q = burst[rng.integers(0, len(burst), n_hot)] + \
        rng.normal(scale=0.05, size=(n_hot, ds.dim)).astype(np.float32)
    for i in range(len(hot_q)):            # record access stats
        idx.search(hot_q[i], k=k, recall_target=target)

    # 4. maintenance -------------------------------------------------------
    m = Maintainer(idx)
    before = m.total_cost()
    t0 = time.perf_counter()
    rep = m.run()
    out["maintenance_s"] = time.perf_counter() - t0
    out.update(cost_before=before, cost_after=m.total_cost(),
               splits=rep.splits, merges=rep.merges,
               rejected=rep.rejected_splits + rep.rejected_merges)
    print(f"maintenance: cost {before:.1f} -> {out['cost_after']:.1f} "
          f"(splits={rep.splits} merges={rep.merges} "
          f"rejected={out['rejected']})")
    idx.check_invariants()

    # 5. recall still holds after structural change ------------------------
    all_vecs = np.concatenate([ds.vectors, burst])
    all_ds = datasets.VectorDataset(
        all_vecs, np.zeros(len(all_vecs), np.int64), ds.centers, metric="l2")
    gt2 = all_ds.ground_truth(q, k)
    recs2 = [recall(idx.search(q[i], k, recall_target=target).ids, gt2[i])
             for i in range(len(q))]
    out.update(recall_after=float(np.mean(recs2)),
               vectors_after=idx.num_vectors,
               partitions_after=idx.levels[0].num_partitions)
    print(f"post-maintenance recall={out['recall_after']:.3f} "
          f"(index now {out['vectors_after']} vectors, "
          f"{out['partitions_after']} partitions)")
    out.update(index=idx, dataset=all_ds)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
