"""Synthetic vector datasets for index runs.

Deterministic generators standing in for SIFT / MSTuring / Wikipedia
embeddings: mixtures of anisotropic Gaussian clusters with power-law
cluster sizes, made with numpy from a seed (the same draws as the JAX
package's generators, so both packages see the same vectors).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class VectorDataset:
    vectors: np.ndarray          # (n, d) float32
    cluster_of: np.ndarray       # (n,) generating cluster id
    centers: np.ndarray          # (c, d)
    metric: str = "l2"

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def ground_truth(self, queries: np.ndarray, k: int, device=None
                     ) -> np.ndarray:
        """Exact top-k ids (brute force, blocked to bound memory).  With a
        ``device`` the distances and the selection run there in f32
        (``torch.matmul`` + ``torch.topk``; a check, not the search)."""
        q = np.ascontiguousarray(queries, np.float32)
        if device is not None:
            return self._ground_truth_torch(q, k, torch.device(device))
        out = np.empty((len(q), k), dtype=np.int64)
        x = self.vectors
        x2 = np.sum(x.astype(np.float64) ** 2, axis=1)
        for i0 in range(0, len(q), 256):
            qs = q[i0:i0 + 256]
            if self.metric == "l2":
                d = x2[None, :] - 2.0 * (qs @ x.T)
            else:
                d = -(qs @ x.T)
            idx = np.argpartition(d, k - 1, axis=1)[:, :k]
            dd = np.take_along_axis(d, idx, axis=1)
            o = np.argsort(dd, axis=1, kind="stable")
            out[i0:i0 + 256] = np.take_along_axis(idx, o, axis=1)
        return out

    def _ground_truth_torch(self, q: np.ndarray, k: int,
                            dev: torch.device) -> np.ndarray:
        x = torch.as_tensor(self.vectors, device=dev)
        x2 = torch.sum(x * x, dim=1)
        out = []
        for i0 in range(0, len(q), 256):
            qs = torch.as_tensor(q[i0:i0 + 256], device=dev)
            d = -(qs @ x.T)
            if self.metric == "l2":
                d = x2[None, :] + 2.0 * d
            out.append(torch.topk(d, k, dim=1, largest=False).indices)
        return torch.cat(out).cpu().numpy().astype(np.int64)


def clustered(n: int, dim: int, n_clusters: int = 64, seed: int = 0,
              spread: float = 1.0, center_scale: float = 6.0,
              power: float = 1.2, metric: str = "l2") -> VectorDataset:
    """Power-law-sized Gaussian mixture ('embedding-like')."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)) * center_scale
    w = (1.0 / np.arange(1, n_clusters + 1) ** power)
    w /= w.sum()
    counts = rng.multinomial(n, w)
    xs, cid = [], []
    for c in range(n_clusters):
        if counts[c] == 0:
            continue
        scale = spread * (0.5 + rng.random())
        xs.append(centers[c] + rng.normal(size=(counts[c], dim)) * scale)
        cid.append(np.full(counts[c], c))
    x = np.concatenate(xs).astype(np.float32)
    cid = np.concatenate(cid)
    perm = rng.permutation(len(x))
    return VectorDataset(x[perm], cid[perm], centers.astype(np.float32),
                         metric)


def uniform(n: int, dim: int, seed: int = 0,
            metric: str = "l2") -> VectorDataset:
    """Uniform Gaussian: the hard case for partitioned indexes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    return VectorDataset(x, np.zeros(n, dtype=np.int64),
                         np.zeros((1, dim), dtype=np.float32), metric)


def queries_near(ds: VectorDataset, n_queries: int, seed: int = 1,
                 jitter: float = 0.1) -> np.ndarray:
    """Queries as jittered data points."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, ds.n, n_queries)
    q = ds.vectors[base] + rng.normal(
        size=(n_queries, ds.dim)).astype(np.float32) * jitter
    return q.astype(np.float32)


def zipf_weights(n: int, a: float = 1.1) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()
