"""GAT (Velickovic et al., arXiv:1710.10903) by edge-list message passing:
the forward of the JAX package's ``models/gnn.py`` in PyTorch.

Gather the endpoints -> per-edge attention scores -> softmax over each
destination's incoming edges -> weighted sum of the messages into the
destination.  The edges are sorted by destination once (stably) and every
segment reduction reads them in that order, with no atomics
(``layers.reduce_sorted``), so a forward gives the same bits on every run.
The training losses are the reference's ``loss_fn`` (node classification,
with an optional label mask) and the pooled molecule loss of its
``families._make_gnn_pooled_step`` (``pooled_loss``), in their one-device
form; the edge-parallel ``axis`` (``_psum``/``_pmax``) waits for the
sharding specs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import resolve_device
from .layers import dense_init, reduce_sorted, segment_sum, sort_segments

Tensor = torch.Tensor


@dataclass(frozen=True)
class GATConfig:
    """The reference's fields but its mesh axes (``dp_axes``)."""
    d_in: int
    d_hidden: int = 8
    n_heads: int = 8
    n_layers: int = 2
    n_classes: int = 7
    negative_slope: float = 0.2


class GATLayer(nn.Module):
    """One layer's weights, as the reference's tree: ``w (d_in, heads,
    d_out)``, ``a_src`` and ``a_dst (heads, d_out)``, ``b (heads,
    d_out)``."""

    def __init__(self, d_in: int, heads: int, d_out: int, make):
        super().__init__()
        self.w = nn.Parameter(make("dense", (d_in, heads, d_out), 0),
                              requires_grad=False)
        self.a_src = nn.Parameter(make("dense", (heads, d_out), 1),
                                  requires_grad=False)
        self.a_dst = nn.Parameter(make("dense", (heads, d_out), 1),
                                  requires_grad=False)
        self.b = nn.Parameter(make("zeros", (heads, d_out)),
                              requires_grad=False)


class GAT(nn.Module):
    """The GAT's weights in f32 on one device, drawn from ``generator``
    (on ``device``; a fresh one seeded with 0 by default) with the
    reference's ``1/sqrt(fan_in)`` std and zero biases: ``n_heads`` heads
    of ``d_hidden`` in every layer but the last, which has one head of
    ``n_classes``.  ``init=False`` leaves the weights unset, for loading
    (``convert.gnn_params_from_jax``)."""

    def __init__(self, cfg: GATConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        dev = resolve_device(device)
        if init and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def make(kind, shape, in_axis=0):
            if not init:
                return torch.empty(shape, device=dev)
            if kind == "dense":
                return dense_init(generator, shape, in_axis)
            return torch.zeros(shape, device=dev)

        self.cfg = cfg
        layers, d_in = [], cfg.d_in
        for i in range(cfg.n_layers):
            last = i == cfg.n_layers - 1
            heads = 1 if last else cfg.n_heads
            d_out = cfg.n_classes if last else cfg.d_hidden
            layers.append(GATLayer(d_in, heads, d_out, make))
            d_in = d_out * heads
        self.layers = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.layers[0].w.device


def _gat_layer_sorted(lp: GATLayer, h: Tensor, src: Tensor, dst: Tensor,
                      lengths: Tensor, cfg: GATConfig, last: bool) -> Tensor:
    """``gat_layer`` on edges already sorted by destination (``lengths``:
    each node's count of incoming edges)."""
    n_nodes = h.shape[0]
    d_in, heads, d_out = lp.w.shape
    wh = (h @ lp.w.reshape(d_in, heads * d_out).to(h.dtype)
          ).reshape(n_nodes, heads, d_out)
    s_src = torch.sum(wh * lp.a_src.to(h.dtype), dim=-1)       # (N, H)
    s_dst = torch.sum(wh * lp.a_dst.to(h.dtype), dim=-1)
    e = F.leaky_relu(s_src[src] + s_dst[dst], cfg.negative_slope)
    # no gradient through the max, which cancels in the softmax (the
    # reference's stop_gradient)
    smax = reduce_sorted(e.detach(), lengths, "max")
    smax = torch.clamp(torch.nan_to_num(smax, neginf=-1e30), min=-1e30)
    ex = torch.exp(e - smax[dst])
    del e
    denom = reduce_sorted(ex, lengths, "sum")
    alpha = ex / torch.clamp(denom[dst], min=1e-20)             # (E, H)
    del ex
    msg = wh[src]                                               # (E, H, dO)
    msg *= alpha[..., None]
    del alpha
    out = reduce_sorted(msg, lengths, "sum") + lp.b.to(h.dtype)
    if last:
        return torch.mean(out, dim=1)                           # avg heads
    out = out.reshape(n_nodes, -1)                              # concat
    return torch.where(out > 0, out, torch.expm1(out))          # ELU


def gat_layer(lp: GATLayer, h: Tensor, src: Tensor, dst: Tensor,
              n_nodes: int, cfg: GATConfig, last: bool) -> Tensor:
    """One GAT layer: h (N, d_in) node features, src/dst (E,) edges in
    any order -> (N, heads * d_out), or (N, d_out) averaged over the heads
    in the last layer.  Scores leaky-ReLU'd at ``negative_slope``; the
    softmax max floored at -1e30 (a node with no incoming edge outputs
    ``b`` alone) and its sum at 1e-20; ELU of the concatenated heads
    between layers."""
    order, lengths = sort_segments(dst, n_nodes)
    return _gat_layer_sorted(lp, h, src[order], dst[order], lengths, cfg,
                             last)


def forward(model: GAT, feats: Tensor, src: Tensor, dst: Tensor) -> Tensor:
    """Node logits (N, n_classes) on the model's device: feats (N, d_in),
    src/dst (E,) integer edges (message from src to dst).  The edges are
    sorted once for every layer."""
    dev = model.device
    h = feats.to(dev)
    order, lengths = sort_segments(dst.to(dev).long(), h.shape[0])
    src, dst = src.to(dev).long()[order], dst.to(dev).long()[order]
    del order
    for i, lp in enumerate(model.layers):
        h = _gat_layer_sorted(lp, h, src, dst, lengths, model.cfg,
                              last=i == len(model.layers) - 1)
    return h


def graph_pool_logits(model: GAT, feats: Tensor, src: Tensor, dst: Tensor,
                      graph_of: Tensor, n_graphs: int) -> Tensor:
    """Batched small graphs (the ``molecule`` shape): node logits
    mean-pooled per graph -> (n_graphs, n_classes); a graph with no node
    pools to 0."""
    node_logits = forward(model, feats, src, dst)
    graph_of = graph_of.to(model.device).long()
    sums = segment_sum(node_logits, graph_of, n_graphs)
    cnt = torch.bincount(graph_of, minlength=n_graphs).float()
    return sums / torch.clamp(cnt[:, None], min=1.0)


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


def loss_fn(model: GAT, feats: Tensor, src: Tensor, dst: Tensor,
            labels: Tensor, label_mask: Optional[Tensor] = None) -> Tensor:
    """Node classification: the cross-entropy of the node logits, the mean
    over the nodes, or over ``label_mask``'s weight (``sum(nll * mask) /
    max(sum(mask), 1)``)."""
    nll = _nll(forward(model, feats, src, dst), labels.to(model.device))
    if label_mask is not None:
        mask = label_mask.to(model.device).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def pooled_loss(model: GAT, feats: Tensor, src: Tensor, dst: Tensor,
                graph_of: Tensor, labels: Tensor, n_graphs: int) -> Tensor:
    """Graph classification over batched small graphs (the ``molecule``
    shape): the mean cross-entropy of ``graph_pool_logits``."""
    logits = graph_pool_logits(model, feats, src, dst, graph_of, n_graphs)
    return torch.mean(_nll(logits, labels.to(model.device)))
