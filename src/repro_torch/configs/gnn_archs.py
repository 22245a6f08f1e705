"""gat-cora [arXiv:1710.10903]: 2 layers, 8 heads of 8, 7 classes, and
the GNN family's four graph shapes, as plain data (the JAX package's
``configs/gnn_archs.py`` and ``GNN_SHAPES`` / ``GNN_SMOKE_SHAPES`` of its
``configs/families.py``; the lowering, ``build_gnn``, is not ported)."""
from __future__ import annotations

from ..models.gnn import GATConfig


def gat_cora() -> GATConfig:
    # d_in is per-shape (each cell fixes its own d_feat); 1433 is Cora's.
    return GATConfig(d_in=1433, d_hidden=8, n_heads=8, n_layers=2,
                     n_classes=7)


def gat_cora_smoke() -> GATConfig:
    return GATConfig(d_in=64, d_hidden=8, n_heads=4, n_layers=2,
                     n_classes=7)


GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2708, n_edges=10556,
                          d_feat=1433),
    "minibatch_lg": dict(kind="full", n_nodes=147_456, n_edges=196_608,
                         d_feat=602),   # padded 1024-seed fanout-15/10 block
    "ogb_products": dict(kind="full", n_nodes=2_449_029,
                         n_edges=61_859_140, d_feat=100),
    "molecule": dict(kind="pooled", n_graphs=128, n_nodes=30, n_edges=64,
                     d_feat=1433),
}
GNN_SMOKE_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=256, n_edges=1024,
                          d_feat=64),
    "minibatch_lg": dict(kind="full", n_nodes=512, n_edges=2048, d_feat=32),
    "ogb_products": dict(kind="full", n_nodes=512, n_edges=4096, d_feat=32),
    "molecule": dict(kind="pooled", n_graphs=4, n_nodes=30, n_edges=64,
                     d_feat=16),
}
