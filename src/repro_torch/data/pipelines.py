"""Deterministic batch pipelines, the JAX package's ``data/pipelines.py``:
every batch is a pure function of (seed, step), drawn in host numpy, so
both packages give the same bytes for the same (seed, step).  The cursor
is the step index, so a training run resumed from a checkpoint's step
regenerates exactly the batches that followed it (``train/loop.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step + 1_000_003]))


@dataclass(frozen=True)
class TokenPipeline:
    """Zipf-distributed synthetic token stream with Markov-ish locality so
    the loss actually decreases during smoke training."""
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed, step)
        b, s, v = self.batch, self.seq_len, self.vocab_size
        # structured stream: tokens repeat locally (predictable structure)
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % v
        rep = rng.random((b, s)) < 0.5
        tokens = base.copy()
        tokens[:, 1:] = np.where(rep[:, 1:], tokens[:, :-1], base[:, 1:])
        return {"tokens": tokens.astype(np.int32)}


@dataclass(frozen=True)
class RecsysPipeline:
    """Click-through batches: dense features, Zipfian categorical ids per
    field, user history sequences, and labels generated from a hidden linear
    model (so training has signal)."""
    batch: int
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 100_000
    hist_len: int = 50
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed, step)
        dense = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        sparse = (rng.zipf(1.2, size=(self.batch, self.n_sparse))
                  % self.vocab).astype(np.int32)
        hist = (rng.zipf(1.2, size=(self.batch, self.hist_len))
                % self.vocab).astype(np.int32)
        hist_len = rng.integers(1, self.hist_len + 1, self.batch)
        hist_mask = (np.arange(self.hist_len)[None, :]
                     < hist_len[:, None])
        target = (rng.zipf(1.2, size=(self.batch,)) % self.vocab
                  ).astype(np.int32)
        # hidden ground-truth model for labels
        w = _rng(self.seed, -1).normal(size=self.n_dense)
        logit = dense @ w + 0.3 * ((sparse.sum(1) % 7) - 3) \
            + 0.5 * ((target % 5) - 2)
        label = (logit + rng.normal(size=self.batch) > 0)
        return {"dense": dense, "sparse": sparse, "history": hist,
                "history_mask": hist_mask.astype(np.bool_),
                "target_item": target,
                "label": label.astype(np.float32)}


@dataclass(frozen=True)
class GraphMinibatchPipeline:
    """Seeded neighbor-sampled minibatches over a fixed CSR graph."""
    graph: object               # CSRGraph
    feats: np.ndarray
    labels: np.ndarray
    batch_nodes: int
    fanouts: Tuple[int, ...] = (15, 10)
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        from .graphs import sampled_subgraph
        rng = _rng(self.seed, step)
        seeds = rng.choice(self.graph.n_nodes, size=self.batch_nodes,
                           replace=False)
        src, dst, nodes = sampled_subgraph(self.graph, seeds, self.fanouts,
                                           seed=self.seed + step)
        return {"src": src, "dst": dst,
                "feats": self.feats[nodes],
                "labels": self.labels[nodes],
                "n_nodes": np.int32(len(nodes))}
