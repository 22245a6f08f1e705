"""Configurable vector-search workload generator (paper §7.1): a numpy
copy of the JAX package's ``data/workload.py``, made from the same seeds.

Parameters mirror the paper's generator: vectors per operation, operation
count, operation mix (read/write ratio) and *spatial skew* — queries and
updates sampled from hot clusters so both read and write skew are
controllable.  Produces a deterministic stream of operations:

    ("insert", vectors, ids) | ("delete", ids) | ("query", vectors, gt_fn)

MSTuring-RO / MSTuring-IH style workloads from the paper are instances
(see ``readonly_workload`` / ``insert_heavy_workload``); the Wikipedia trace
lives in ``wikipedia.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .datasets import VectorDataset, zipf_weights


@dataclass
class WorkloadConfig:
    n_operations: int = 100
    vectors_per_op: int = 1000
    read_fraction: float = 0.5        # share of ops that are query batches
    delete_fraction: float = 0.0      # share of *write* ops that delete
    query_skew: float = 0.0           # 0 = uniform; >0 = zipf over clusters
    write_skew: float = 0.0
    queries_per_op: int = 100
    k: int = 10
    seed: int = 0


@dataclass
class Operation:
    kind: str                          # insert | delete | query
    vectors: Optional[np.ndarray] = None
    ids: Optional[np.ndarray] = None
    queries: Optional[np.ndarray] = None


@dataclass
class Workload:
    """Materialized operation stream + initial state."""
    initial_vectors: np.ndarray
    initial_ids: np.ndarray
    operations: List[Operation]
    dataset: VectorDataset
    config: WorkloadConfig

    def resident_ids_after(self, t: int) -> np.ndarray:
        """Ids resident in the index after operation t (for ground truth)."""
        alive = set(self.initial_ids.tolist())
        for op in self.operations[:t + 1]:
            if op.kind == "insert":
                alive.update(op.ids.tolist())
            elif op.kind == "delete":
                alive.difference_update(op.ids.tolist())
        return np.asarray(sorted(alive), dtype=np.int64)


class IncrementalGroundTruth:
    """Brute-force top-k ground truth over the *resident* subset of a
    dataset, maintained incrementally across a workload replay.

    The per-op replay loops used to rebuild the sorted resident-id array
    and re-slice the ``(N_res, d)`` matrix from scratch before every
    query op — an O(N) re-materialization on top of the unavoidable
    O(B*N_res) GEMM.  This helper tracks inserts/deletes as set edits and
    materializes the resident matrix (plus cached squared norms for L2)
    lazily, only when a query op actually arrives after a membership
    change.  With a ``device`` the resident matrix lives there and the
    distances and the selection run there in f32 (``torch.matmul`` +
    ``torch.topk``; a check, not the search).
    """

    def __init__(self, ds: VectorDataset,
                 initial_ids: Optional[np.ndarray] = None, device=None):
        self.ds = ds
        self.device = None if device is None else torch.device(device)
        self._resident = set() if initial_ids is None else \
            {int(i) for i in initial_ids}
        self._dirty = True
        self._ids: Optional[np.ndarray] = None      # sorted resident ids
        self._x: Optional[np.ndarray] = None        # (N_res, d) view
        self._x2: Optional[np.ndarray] = None       # cached ||x||^2 (l2)

    @property
    def resident_ids(self) -> np.ndarray:
        self._materialize()
        return self._ids

    def insert(self, ids: np.ndarray) -> None:
        self._resident.update(int(i) for i in np.asarray(ids).ravel())
        self._dirty = True

    def delete(self, ids: np.ndarray) -> None:
        self._resident.difference_update(
            int(i) for i in np.asarray(ids).ravel())
        self._dirty = True

    def apply(self, op: "Operation") -> None:
        """Fold one workload operation's membership effect."""
        if op.kind == "insert":
            self.insert(op.ids)
        elif op.kind == "delete":
            self.delete(op.ids)

    def _materialize(self) -> None:
        if not self._dirty:
            return
        self._ids = np.asarray(sorted(self._resident), dtype=np.int64)
        self._x = self.ds.vectors[self._ids]
        if self.device is not None:
            self._x = torch.as_tensor(self._x, device=self.device)
            self._x2 = (torch.sum(self._x * self._x, dim=1)
                        if self.ds.metric == "l2" else None)
        else:
            self._x2 = (np.sum(self._x.astype(np.float64) ** 2, axis=1)
                        if self.ds.metric == "l2" else None)
        self._dirty = False

    def topk(self, queries: np.ndarray, k: int) -> np.ndarray:
        """(B, k) external-id ground truth for ``queries`` against the
        current resident set (exact, brute force)."""
        self._materialize()
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if len(self._ids) == 0:
            return np.full((q.shape[0], k), -1, dtype=np.int64)
        if self.device is not None:
            return self._topk_torch(q, k)
        if self.ds.metric == "l2":
            d = self._x2[None, :] - 2.0 * (q @ self._x.T)
        else:
            d = -(q @ self._x.T)
        kk = min(k, d.shape[1])
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        order = np.take_along_axis(d, part, axis=1).argsort(
            axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1)
        out = self._ids[idx]
        if kk < k:
            out = np.concatenate(
                [out, np.full((q.shape[0], k - kk), -1, np.int64)], axis=1)
        return out

    def _topk_torch(self, q: np.ndarray, k: int) -> np.ndarray:
        kk = min(k, len(self._ids))
        out = []
        for i0 in range(0, len(q), 256):
            qs = torch.as_tensor(q[i0:i0 + 256], device=self.device)
            d = -(qs @ self._x.T)
            if self.ds.metric == "l2":
                d = self._x2[None, :] + 2.0 * d
            out.append(torch.topk(d, kk, dim=1, largest=False).indices)
        idx = torch.cat(out).cpu().numpy()
        res = self._ids[idx]
        if kk < k:
            res = np.concatenate(
                [res, np.full((q.shape[0], k - kk), -1, np.int64)], axis=1)
        return res


def generate(ds: VectorDataset, cfg: WorkloadConfig,
             initial_fraction: float = 0.3) -> Workload:
    """Build a workload over ``ds``: a fraction of vectors resident up front,
    the rest streamed in; queries jittered residents with cluster skew."""
    rng = np.random.default_rng(cfg.seed)
    n = ds.n
    n_init = int(n * initial_fraction)
    perm = rng.permutation(n)
    init, pool = perm[:n_init], perm[n_init:]
    pool_pos = 0
    resident = list(init)

    n_clusters = len(ds.centers)
    qw = zipf_weights(n_clusters, 1.0 + cfg.query_skew) \
        if cfg.query_skew > 0 else np.full(n_clusters, 1.0 / n_clusters)
    ww = zipf_weights(n_clusters, 1.0 + cfg.write_skew) \
        if cfg.write_skew > 0 else np.full(n_clusters, 1.0 / n_clusters)
    # randomize which clusters are hot (decoupled from cluster id)
    qw = qw[rng.permutation(n_clusters)]
    ww = ww[rng.permutation(n_clusters)]

    ops: List[Operation] = []
    for t in range(cfg.n_operations):
        if rng.random() < cfg.read_fraction:
            res = np.asarray(resident)
            cids = rng.choice(n_clusters, size=cfg.queries_per_op, p=qw)
            base = np.empty(cfg.queries_per_op, dtype=np.int64)
            res_cluster = ds.cluster_of[res]
            for c in np.unique(cids):
                cand = res[res_cluster == c]
                if len(cand) == 0:
                    cand = res
                sel = cids == c
                base[sel] = rng.choice(cand, size=int(sel.sum()))
            q = (ds.vectors[base]
                 + rng.normal(size=(cfg.queries_per_op, ds.dim))
                 .astype(np.float32) * 0.05)
            ops.append(Operation("query", queries=q.astype(np.float32)))
        elif (cfg.delete_fraction > 0
              and rng.random() < cfg.delete_fraction
              and len(resident) > cfg.vectors_per_op * 2):
            res = np.asarray(resident)
            cids = rng.choice(n_clusters, size=cfg.vectors_per_op, p=ww)
            res_cluster = ds.cluster_of[res]
            victims: List[int] = []
            for c in np.unique(cids):
                cand = res[res_cluster == c]
                if len(cand) == 0:
                    cand = res
                sel = int((cids == c).sum())
                victims.extend(rng.choice(cand, size=min(sel, len(cand)),
                                          replace=False).tolist())
            victims = np.unique(np.asarray(victims, dtype=np.int64))
            resident = [r for r in resident if r not in set(victims.tolist())]
            ops.append(Operation("delete", ids=victims))
        else:
            take = min(cfg.vectors_per_op, len(pool) - pool_pos)
            if take <= 0:
                ops.append(Operation("query", queries=ds.vectors[
                    rng.integers(0, n, cfg.queries_per_op)]))
                continue
            ids = pool[pool_pos:pool_pos + take]
            pool_pos += take
            resident.extend(ids.tolist())
            ops.append(Operation("insert", vectors=ds.vectors[ids],
                                 ids=ids.astype(np.int64)))
    return Workload(initial_vectors=ds.vectors[init],
                    initial_ids=init.astype(np.int64),
                    operations=ops, dataset=ds, config=cfg)


def readonly_workload(ds: VectorDataset, n_ops: int = 20,
                      queries_per_op: int = 200, skew: float = 0.5,
                      seed: int = 0) -> Workload:
    """MSTuring-RO analogue: pure search."""
    return generate(ds, WorkloadConfig(
        n_operations=n_ops, read_fraction=1.0, query_skew=skew,
        queries_per_op=queries_per_op, seed=seed), initial_fraction=1.0)


def insert_heavy_workload(ds: VectorDataset, n_ops: int = 50,
                          vectors_per_op: int = 2000,
                          queries_per_op: int = 100,
                          seed: int = 0) -> Workload:
    """MSTuring-IH analogue: 90% insert / 10% search, growing 10x."""
    return generate(ds, WorkloadConfig(
        n_operations=n_ops, read_fraction=0.1,
        vectors_per_op=vectors_per_op, queries_per_op=queries_per_op,
        write_skew=0.5, seed=seed), initial_fraction=0.1)
