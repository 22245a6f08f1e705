"""Graph substrate: CSR graphs, generators and the neighbour sampler, the
JAX package's ``data/graphs.py`` (numpy only, so the same seed gives the
same arrays in both packages).

Message passing runs on edge lists (``models/gnn.py``); the
``minibatch_lg`` shape needs a real neighbour sampler (fanout 15-10),
here over CSR with deterministic numpy sampling.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray     # (n+1,) int64
    indices: np.ndarray    # (nnz,) int32 — neighbor ids
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)


def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.searchsorted(src, np.arange(n_nodes + 1))
    return CSRGraph(indptr.astype(np.int64), dst.astype(np.int32), n_nodes)


def to_edges(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray]:
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int32), g.degree())
    return src, g.indices


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def community_graph(n_nodes: int, avg_degree: float, n_comm: int = 16,
                    p_in: float = 0.9, d_feat: int = 64, n_classes: int = 7,
                    seed: int = 0) -> Tuple[CSRGraph, np.ndarray, np.ndarray]:
    """Cora/citation-like: community structure, features correlated with
    labels.  Returns (graph, features (n, d), labels (n,))."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comm, n_nodes)
    n_edges = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.random(n_edges) < p_in
    dst = np.empty(n_edges, dtype=np.int64)
    # intra-community edges: pick a random node from the same community
    order = np.argsort(comm, kind="stable")
    bounds = np.searchsorted(comm[order], np.arange(n_comm + 1))
    for c in range(n_comm):
        sel = same & (comm[src] == c)
        pool = order[bounds[c]:bounds[c + 1]]
        if len(pool) and sel.any():
            dst[sel] = rng.choice(pool, size=int(sel.sum()))
    dst[~same] = rng.integers(0, n_nodes, int((~same).sum()))
    # symmetrize
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    keep = s != d
    g = from_edges(s[keep], d[keep], n_nodes)
    labels = comm % n_classes
    proto = rng.normal(size=(n_classes, d_feat)) * 2.0
    feats = (proto[labels] + rng.normal(size=(n_nodes, d_feat))
             ).astype(np.float32)
    return g, feats, labels.astype(np.int32)


def power_law_graph(n_nodes: int, avg_degree: float,
                    seed: int = 0) -> CSRGraph:
    """Preferential-attachment-ish degree distribution (products/reddit-like
    topology at reduced scale)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n_nodes * avg_degree)
    # Zipf-weighted endpoints give heavy-tailed degrees cheaply
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.5
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w)
    dst = rng.integers(0, n_nodes, n_edges)
    keep = src != dst
    s = np.concatenate([src[keep], dst[keep]])
    d = np.concatenate([dst[keep], src[keep]])
    return from_edges(s, d, n_nodes)


def molecule_batch(batch: int, n_nodes: int = 30, n_edges: int = 64,
                   d_feat: int = 16, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched small graphs (block-diagonal edge list).

    Returns (src, dst, feats (batch*n_nodes, d), graph_of (batch*n_nodes,)).
    """
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for b in range(batch):
        # random connected-ish molecule: a path + random chords
        path = np.arange(n_nodes - 1)
        s = np.concatenate([path, rng.integers(0, n_nodes,
                                               n_edges - (n_nodes - 1))])
        t = np.concatenate([path + 1, rng.integers(0, n_nodes,
                                                   n_edges - (n_nodes - 1))])
        srcs.append(s + b * n_nodes)
        dsts.append(t + b * n_nodes)
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    feats = rng.normal(size=(batch * n_nodes, d_feat)).astype(np.float32)
    graph_of = np.repeat(np.arange(batch, dtype=np.int32), n_nodes)
    return src, dst, feats, graph_of


# ---------------------------------------------------------------------------
# Neighbor sampler (minibatch_lg shape)
# ---------------------------------------------------------------------------

@dataclass
class SampledBlock:
    """One hop of a sampled computation graph, padded to fixed fanout.

    ``neighbors[i, f]`` is the f-th sampled neighbor of seed i (self-loop
    padding when degree < fanout — standard GraphSAGE practice)."""
    seeds: np.ndarray          # (n_seeds,)
    neighbors: np.ndarray      # (n_seeds, fanout) int32
    mask: np.ndarray           # (n_seeds, fanout) bool — real vs padded


def sample_blocks(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                  rng: np.random.Generator) -> List[SampledBlock]:
    """Multi-hop fanout sampling: returns blocks outermost-hop-last; the
    frontier of each block is the seed set of the next."""
    blocks: List[SampledBlock] = []
    frontier = np.asarray(seeds, dtype=np.int64)
    for fanout in fanouts:
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        neigh = np.empty((len(frontier), fanout), dtype=np.int32)
        mask = deg[:, None] > 0
        # vectorized sample-with-replacement from each neighbor list
        offs = (rng.random((len(frontier), fanout))
                * np.maximum(deg, 1)[:, None]).astype(np.int64)
        neigh = g.indices[(g.indptr[frontier][:, None] + offs)
                          .astype(np.int64)]
        neigh = np.where(mask, neigh, frontier[:, None].astype(np.int32))
        blocks.append(SampledBlock(
            seeds=frontier, neighbors=neigh,
            mask=np.broadcast_to(mask, neigh.shape)))
        frontier = np.unique(neigh.ravel()).astype(np.int64)
    return blocks


def sampled_subgraph(g: CSRGraph, seeds: np.ndarray,
                     fanouts: Sequence[int], seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten sampled blocks into one (src, dst, nodes) edge list over a
    compacted node set — the form models/gnn.py consumes."""
    rng = np.random.default_rng(seed)
    blocks = sample_blocks(g, seeds, fanouts, rng)
    srcs, dsts = [], []
    for blk in blocks:
        s = np.repeat(blk.seeds, blk.neighbors.shape[1])
        d = blk.neighbors.ravel()
        keep = blk.mask.ravel()
        srcs.append(d[keep])           # message flows neighbor -> seed
        dsts.append(s[keep])
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    nodes = np.unique(np.concatenate([src, dst]))
    remap = np.full(g.n_nodes, -1, dtype=np.int64)
    remap[nodes] = np.arange(len(nodes))
    return (remap[src].astype(np.int32), remap[dst].astype(np.int32),
            nodes.astype(np.int64))
