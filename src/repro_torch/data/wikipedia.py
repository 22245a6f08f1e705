"""Wikipedia-12M-style workload (paper §7.1, scaled down): a numpy copy
of the JAX package's ``data/wikipedia.py``, made from the same seeds.

Reproduces the *structure* of the paper's trace from public pageview
dynamics without the 12M-embedding download:

  * the corpus grows month over month (new pages arrive in clustered bursts
    — fresh topics concentrate in embedding-space regions: write skew),
  * query traffic follows a Zipf popularity distribution over pages whose
    hot set *drifts* between months (read skew + temporal drift),
  * each month = one insert batch followed by a query batch at roughly the
    paper's 50/50 read/write ratio, inner-product metric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .datasets import VectorDataset, zipf_weights
from .workload import Operation, Workload, WorkloadConfig


def wikipedia_workload(n_total: int = 60_000, dim: int = 48,
                       months: int = 12, initial_fraction: float = 0.15,
                       queries_per_month: int = 1000, zipf_a: float = 1.05,
                       drift: float = 0.15, n_topics: int = 64,
                       seed: int = 0) -> Workload:
    """Scaled Wikipedia-12M analogue (defaults ~60k vectors, 12 months)."""
    rng = np.random.default_rng(seed)
    # topic centers; later topics appear over time (new-page bursts)
    centers = rng.normal(size=(n_topics, dim)) * 5.0
    topic_birth = np.sort(rng.integers(0, months, n_topics))
    topic_birth[: n_topics // 4] = 0  # a quarter of topics exist at t=0

    # allocate pages to topics with power-law sizes
    w = zipf_weights(n_topics, 1.1)
    counts = rng.multinomial(n_total, w)
    vecs, topic_of, birth = [], [], []
    for t in range(n_topics):
        if counts[t] == 0:
            continue
        v = centers[t] + rng.normal(size=(counts[t], dim))
        vecs.append(v)
        topic_of.append(np.full(counts[t], t))
        birth.append(np.full(counts[t], topic_birth[t]))
    x = np.concatenate(vecs).astype(np.float32)
    topic_of = np.concatenate(topic_of)
    birth = np.concatenate(birth)
    # normalize-ish for inner product (embeddings trained w/ dot similarity)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-6) / 4.0
    ds = VectorDataset(x, topic_of, centers.astype(np.float32), metric="ip")

    # month-0 residents: born at 0, plus a slice of everything else
    init_mask = birth == 0
    extra = rng.random(n_total) < initial_fraction
    init_mask |= extra & (birth == 0)
    init_ids = np.where(init_mask)[0]

    # per-page popularity: Zipf, re-ranked each month by a drifting score
    pop_rank = rng.permutation(n_total).astype(np.float64)
    ops: List[Operation] = []
    resident = init_ids.tolist()
    resident_set = set(resident)
    for m in range(1, months + 1):
        # --- monthly insert burst: pages born this month ---
        newly = np.where(birth == min(m, months - 1))[0]
        newly = np.asarray([i for i in newly if i not in resident_set],
                           dtype=np.int64)
        if len(newly):
            ops.append(Operation("insert", vectors=x[newly],
                                 ids=newly))
            resident.extend(newly.tolist())
            resident_set.update(newly.tolist())
        # --- popularity drift ---
        pop_rank += rng.normal(size=n_total) * drift * n_total
        res = np.asarray(resident)
        order = np.argsort(pop_rank[res])
        zw = zipf_weights(len(res), zipf_a)
        probs = np.empty(len(res))
        probs[order] = zw
        # --- monthly queries sampled by popularity ---
        qsel = rng.choice(res, size=queries_per_month, p=probs)
        q = x[qsel] + rng.normal(
            size=(queries_per_month, dim)).astype(np.float32) * 0.05
        ops.append(Operation("query", queries=q.astype(np.float32)))

    cfg = WorkloadConfig(n_operations=len(ops), seed=seed)
    return Workload(initial_vectors=x[init_ids],
                    initial_ids=init_ids.astype(np.int64),
                    operations=ops, dataset=ds, config=cfg)
