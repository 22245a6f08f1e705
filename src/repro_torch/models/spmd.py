"""One rank's part of the LM (dense and MoE) on a mesh: training loss,
prefill and decode, written out per rank.

Its counterpart is the partition that GSPMD makes of the reference's
``models/transformer.py`` under ``param_specs``, ``_act_specs`` and
``cache_specs``; here the partition is explicit, with every collective
through the ``launch.mesh.Mesh`` (which records it).  Each rank holds
exactly the reference's storage layout (``transformer.param_specs``:
local shards by the port's parameter names) and:

- FSDP over the data axes (``cfg.dp_axes``): each layer's shards are
  all-gathered before use, and the backward reduce-scatters their
  gradients (the all-gather's conjugate);
- tensor parallelism over the model axis for the heads and ``d_ff``:
  each rank takes whole query heads, ``H / tp`` of them in order when tp
  divides H (its columns of ``wq`` are its storage shard), else the
  ``[t H // tp, (t + 1) H // tp)`` heads, whose columns it gathers over
  the model axis; the kv heads its query heads read likewise (several
  ranks compute a kv head that they share); ``wo`` and ``w_down`` are
  row-parallel, their partial sums reduce-scattered;
- sequence parallelism (``seq_shard_activations``): between blocks the
  residual is ``(B / dp, S / tp, D)``; a block all-gathers its normed
  input over the model axis and reduce-scatters its output back
  (Megatron-SP); the embedding is vocab-parallel (a masked local lookup,
  reduce-scattered), and so are the logits and the cross-entropy
  (``pmax``/``psum`` of the partial softmax terms over the model axis);
- expert parallelism over the model axis for the routed experts
  (``w_gate: P(tp, dp, None)``): every rank routes all of its batch's
  tokens the same way (the all-gathered input, whose backward keeps the
  rank's slice, ``invariant``), runs its ``E / tp`` experts, and the
  partial outputs join the same reduce-scatter; the Switch aux term
  averages its statistics over the data axes;
- decode on a sequence-sharded cache (``build_lm`` picks that layout
  when the kv heads do not divide the model axis, as for all five LMs at
  16; ``long_500k`` spreads the sequence over every axis): q, k and v are
  column-parallel and all-gathered, the new position is written by the
  rank that holds it, each rank attends over its slice of the cache and
  the partial softmax is combined with ``pmax``/``psum``.

A tensor replicated over axes along which the computation varies (a
norm's scale, a bias, a gate) enters through ``Mesh.pvary``, whose
backward sums its gradient over them.  On a one-rank mesh every
collective is the identity and the functions compute what the one-device
``Transformer`` does.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import NEG_INF, flash_attention
from .layers import apply_rope, rmsnorm, rope_frequencies
from .layers import flash_attention as train_attention
from .transformer import (TransformerConfig, _act_specs, _constrain,
                          moe_experts, param_specs, route, swiglu)

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclass
class Layout:
    """Where one rank sits and which heads and experts it takes."""
    dp: Tuple[str, ...]          # data axes present in the mesh
    tp: Tuple[str, ...]          # the model axis, if present
    t: int                       # this rank's index along the model axis
    h0: int                      # its query heads [h0, h1)
    h1: int
    k0: int                      # the kv heads they read [k0, k1)
    k1: int
    q_even: bool                 # its heads are its storage shard of wq
    kv_even: bool                # ... and of wk / wv
    e0: int = 0                  # its routed experts [e0, e1)
    e1: int = 0


def layout(cfg: TransformerConfig, mesh) -> Layout:
    dp = mesh.present(cfg.dp_axes)
    tp = mesh.present((cfg.tp_axis,))
    n, t = mesh.axis_size(tp), mesh.index(tp)
    h, kh = cfg.n_heads, cfg.n_kv_heads
    rep = h // kh
    q_even = h % n == 0
    h0, h1 = (t * h // n, (t + 1) * h // n)
    k0, k1 = h0 // rep, (h1 - 1) // rep + 1 if h1 > h0 else h0 // rep
    kv_even = q_even and kh % n == 0
    lay = Layout(dp, tp, t, h0, h1, k0, k1, q_even, kv_even)
    if cfg.moe is not None:
        el = cfg.moe.n_experts // n
        lay.e0, lay.e1 = t * el, (t + 1) * el
    return lay


class Fetch:
    """A rank's view of its parameters: ``get(name)`` gathers a local
    shard over the data axes its spec splits it over (the model axis too
    with ``tp_too``), after ``pvary`` over the axes of ``vary`` (default
    the view's) that it is not split over: those along which the
    computation that reads it differs."""

    def __init__(self, params: Params, cfg: TransformerConfig, mesh,
                 vary: Tuple[str, ...]):
        self.p, self.cfg, self.mesh = params, cfg, mesh
        self.specs = param_specs(cfg)
        self.vary = vary

    def get(self, name: str, tp_too: bool = False,
            vary: Optional[Tuple[str, ...]] = None) -> Tensor:
        mesh, spec = self.mesh, self.specs[name]
        w = self.p[name]
        split = set(mesh.present(spec.all_axes()))
        vary = tuple(a for a in (self.vary if vary is None else vary)
                     if a not in split)
        w = mesh.pvary(w, vary)
        for dim in range(len(spec)):
            axes = mesh.present(spec.axes(dim))
            if not tp_too:
                axes = tuple(a for a in axes if a != self.cfg.tp_axis)
            if axes:
                w = mesh.all_gather(w, axes, dim=dim)
        return w


def _heads_cols(f: Fetch, name: str, lo: int, hi: int, even: bool,
                dh: int, dim: int = -1) -> Tensor:
    """Columns (rows with ``dim=0``) of heads [lo, hi) of a
    head-split weight: the storage shard when ``even``, else gathered
    over the model axis too and sliced."""
    if even:
        return f.get(name)
    w = f.get(name, tp_too=True)
    return w.narrow(dim, lo * dh, (hi - lo) * dh)


def _kv_map(lay: Layout, rep: int):
    """The kv head (index into [k0, k1)) each local query head reads, or
    None when the local heads group evenly over the local kv heads."""
    idx = [h // rep - lay.k0 for h in range(lay.h0, lay.h1)]
    hq, hk = lay.h1 - lay.h0, lay.k1 - lay.k0
    if hk and hq % hk == 0 and idx == [i // (hq // hk) for i in range(hq)]:
        return None
    return torch.tensor(idx, dtype=torch.long)


def _attend(q, k, v, lay: Layout, rep: int, fn: Callable, **kw) -> Tensor:
    """``fn(q, k, v, **kw)`` with each local query head against its kv
    head: k/v repeated per query head where the local heads do not group
    evenly."""
    if q.shape[2] == 0:              # a rank with no heads (H < tp)
        return q
    m = _kv_map(lay, rep)
    if m is not None:
        m = m.to(k.device)
        k, v = k.index_select(2, m), v.index_select(2, m)
    return fn(q, k, v, **kw)


# ---------------------------------------------------------------------------
# Embedding and the vocab-parallel logits
# ---------------------------------------------------------------------------

def _embed_partial(f: Fetch, tokens: Tensor, dtype) -> Tensor:
    """This rank's vocab rows' share of the embedding of ``tokens``
    (zeros for the others), in ``dtype``."""
    emb = f.get("embed")                                  # (V / tp, D)
    vl = emb.shape[0]
    off = f.mesh.index(f.mesh.present((f.cfg.tp_axis,))) * vl
    loc = tokens.long() - off
    hit = (loc >= 0) & (loc < vl)
    rows = emb.index_select(0, loc.clamp(0, vl - 1).reshape(-1))
    rows = rows.reshape(*tokens.shape, emb.shape[1]).to(dtype)
    return torch.where(hit[..., None], rows, torch.zeros((), dtype=dtype,
                                                         device=rows.device))


def _vocab_nll(lg: Tensor, tgt: Tensor, mesh, tp, off: int) -> Tensor:
    """Per-position ``logsumexp - gold`` of f32 logits split over the
    vocabulary: ``lg`` (..., V / tp) this rank's columns from ``off``."""
    m = mesh.pmax(torch.amax(lg, dim=-1), tp)
    se = mesh.psum(torch.sum(torch.exp(lg - m[..., None]), dim=-1), tp)
    loc = tgt.long() - off
    hit = (loc >= 0) & (loc < lg.shape[-1])
    gold = torch.gather(lg, -1, loc.clamp(0, lg.shape[-1] - 1)[..., None])
    gold = mesh.psum(torch.where(hit, gold[..., 0], 0.0), tp)
    return m + torch.log(se) - gold


# ---------------------------------------------------------------------------
# The block (training and prefill)
# ---------------------------------------------------------------------------

def _qkv_local(f: Fetch, i: int, hg: Tensor, lay: Layout, cfg):
    """q, k, v of the rank's heads from the gathered input hg (B, S, D)."""
    dh = cfg.head_dim
    b, s, _ = hg.shape
    pre = f"blocks.{i}."
    wq = _heads_cols(f, pre + "wq", lay.h0, lay.h1, lay.q_even, dh)
    wk = _heads_cols(f, pre + "wk", lay.k0, lay.k1, lay.kv_even, dh)
    wv = _heads_cols(f, pre + "wv", lay.k0, lay.k1, lay.kv_even, dh)
    q, k, v = hg @ wq.to(hg.dtype), hg @ wk.to(hg.dtype), hg @ wv.to(hg.dtype)
    if cfg.qkv_bias:
        q = q + _heads_cols(f, pre + "bq", lay.h0, lay.h1, lay.q_even,
                            dh).to(hg.dtype)
        k = k + _heads_cols(f, pre + "bk", lay.k0, lay.k1, lay.kv_even,
                            dh).to(hg.dtype)
        v = v + _heads_cols(f, pre + "bv", lay.k0, lay.k1, lay.kv_even,
                            dh).to(hg.dtype)
    return (q.reshape(b, s, lay.h1 - lay.h0, dh),
            k.reshape(b, s, lay.k1 - lay.k0, dh),
            v.reshape(b, s, lay.k1 - lay.k0, dh))


def _seq_gather(mesh, x: Tensor, lay: Layout, cfg,
                invariant: bool = False) -> Tensor:
    if not cfg.seq_shard_activations:
        return x
    return mesh.all_gather(x, lay.tp, dim=1, invariant=invariant)


def _seq_scatter(mesh, x: Tensor, lay: Layout, cfg) -> Tensor:
    if not cfg.seq_shard_activations:
        return mesh.psum(x, lay.tp)
    return mesh.psum_scatter(x, lay.tp, dim=1)


def _moe_partial(f: Fetch, i: int, hg: Tensor, lay: Layout, cfg,
                 mesh) -> Tuple[Tensor, Tensor, Tensor]:
    """The rank's routed experts' share of the MoE FFN of ``hg`` (B, S,
    D), invariant over the model axis: (partial out in hg's dtype, the
    layer's mean router probabilities ``me`` and first-choice shares
    ``ce`` over the rank's groups).  ``route``, then ``moe_experts`` on
    experts [e0, e1)."""
    pre = f"blocks.{i}.moe."
    # the routing is the same on every rank of the model axis
    router = f.get(pre + "router", vary=tuple(a for a in f.vary
                                              if a not in lay.tp))
    r = route(SimpleNamespace(router=router), hg, cfg.moe)
    r = dataclasses.replace(r, xg=mesh.pvary(r.xg, lay.tp),
                            top_w=mesh.pvary(r.top_w, lay.tp))
    out = moe_experts(r, lambda n: f.get(pre + n), hg.shape, lay.e0)
    return out, r.me, r.ce


def _ffn_partial(f: Fetch, i: int, h2: Tensor, lay: Layout, cfg, mesh,
                 gather: Callable) -> Tuple[Tensor, Optional[Tuple]]:
    """The FFN's partial sum over the model axis (B, S, D) from the normed
    local input ``h2``: the dense SwiGLU column/row-parallel, or the
    rank's experts plus the shared experts' columns; with the MoE's
    (me, ce)."""
    pre = f"blocks.{i}."
    if cfg.moe is None:
        return swiglu(gather(h2, False), lambda n: f.get(pre + n)), None
    hg = gather(h2, True)                       # invariant: routed alike
    out, me, ce = _moe_partial(f, i, hg, lay, cfg, mesh)
    if cfg.moe.n_shared:
        out = out + swiglu(mesh.pvary(hg, lay.tp),
                           lambda n: f.get(pre + "shared_mlp." + n))
    return out, (me, ce)


def _block(f: Fetch, i: int, x: Tensor, lay: Layout, cfg, mesh,
           positions: Tensor, freqs: Tensor, attention: Callable,
           train: bool, glob: Tuple[int, int]):
    """One layer on the rank's residual x (B/dp, S/tp, D): (x out, the
    MoE's (me, ce) or None, the rank's (k, v) of the layer)."""
    pre = f"blocks.{i}."
    sp = _act_specs(cfg)
    gather = (lambda t, inv: _seq_gather(mesh, t, lay, cfg, inv))
    h = rmsnorm(x, f.get(pre + "ln1").to(x.dtype))
    hg = gather(h, False)
    q, k, v = _qkv_local(f, i, hg, lay, cfg)
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    rep = cfg.n_heads // cfg.n_kv_heads
    if train:
        att = _attend(q, k, v, lay, rep, train_attention, causal=True,
                      q_block=cfg.q_block, k_block=cfg.k_block,
                      grouped=cfg.attn_grouped)
    else:
        att = _attend(q, k, v, lay, rep, attention, causal=True,
                      q_block=cfg.q_block, k_block=cfg.k_block)
    b, s = att.shape[:2]
    dh = cfg.head_dim
    wo = _heads_cols(f, pre + "wo", lay.h0, lay.h1, lay.q_even, dh, dim=0)
    o = att.reshape(b, s, (lay.h1 - lay.h0) * dh) @ wo.to(x.dtype)
    x = x + _constrain(_seq_scatter(mesh, o, lay, cfg), sp["resid"], mesh,
                       (glob[0], glob[1], cfg.d_model))
    h2 = rmsnorm(x, f.get(pre + "ln2").to(x.dtype))
    fo, stats = _ffn_partial(f, i, h2, lay, cfg, mesh, gather)
    x = x + _constrain(_seq_scatter(mesh, fo, lay, cfg), sp["resid"], mesh,
                       (glob[0], glob[1], cfg.d_model))
    return x, stats, (k, v)


def _aux(stats, cfg, mesh, lay: Layout) -> Tensor:
    """The Switch aux term from the statistics averaged over the data
    axes (equal group counts a rank)."""
    me, ce = stats
    n = mesh.axis_size(lay.dp)
    me = mesh.psum(me, lay.dp) / n
    ce = mesh.psum(ce, lay.dp) / n
    return cfg.moe.n_experts * torch.sum(me * ce) \
        * cfg.moe.router_aux_weight


def _start(f: Fetch, tokens: Tensor, lay: Layout, cfg, mesh):
    """The residual (B/dp, S/tp, D) of the rank's tokens (B/dp, S)."""
    e = _embed_partial(f, tokens, cfg.compute_dtype)
    x = _seq_scatter(mesh, e, lay, cfg)
    b, s = tokens.shape
    return _constrain(x, _act_specs(cfg)["resid"], mesh,
                      (b * mesh.axis_size(lay.dp), s, cfg.d_model))


def hidden_states(params: Params, tokens: Tensor, cfg: TransformerConfig,
                  mesh) -> Tuple[Tensor, Tensor]:
    """``transformer.hidden_states`` of the rank's tokens (B/dp, S): (its
    residual after the final norm (B/dp, S/tp, D), the MoE aux term
    summed over the layers)."""
    lay = layout(cfg, mesh)
    f = Fetch(params, cfg, mesh, lay.dp + lay.tp)
    dev = tokens.device
    b, s = tokens.shape
    x = _start(f, tokens, lay, cfg, mesh)
    positions = torch.arange(s, device=dev).expand(b, s)
    freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, dev)
    glob = (b * mesh.axis_size(lay.dp), s)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(i, x):
        x, stats, _ = _block(f, i, x, lay, cfg, mesh, positions, freqs,
                             None, True, glob)
        a = _aux(stats, cfg, mesh, lay) if stats is not None else None
        return x, a

    for i in range(cfg.n_layers):
        if remat:
            x, a = checkpoint(layer, i, x, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = layer(i, x)
        if a is not None:
            aux = aux + a
    return rmsnorm(x, f.get("ln_f").to(x.dtype)), aux


def lm_loss_chunked(params: Params, tokens: Tensor, cfg: TransformerConfig,
                    mesh, n_global: int, chunk: int = 512) -> Tensor:
    """``transformer.lm_loss_chunked`` of the rank's tokens: the
    vocab-parallel cross-entropy of each ``chunk`` positions under
    ``torch.utils.checkpoint``, the chunk sums added in order, summed
    over the data axes and divided by ``n_global`` x (S - 1), plus the
    aux term (the same value on every rank)."""
    lay = layout(cfg, mesh)
    x, aux = hidden_states(params, tokens, cfg, mesh)
    x = _seq_gather(mesh, x, lay, cfg)                    # (B/dp, S, D)
    f = Fetch(params, cfg, mesh, lay.dp)
    head = f.get("lm_head")                               # (D, V / tp)
    off = lay.t * head.shape[1]
    b, s, _ = x.shape
    tokens = tokens.long()
    n_chunks = -(-s // chunk)
    s_pad = n_chunks * chunk
    x = F.pad(x, (0, 0, 0, s_pad - s))
    tgt = F.pad(tokens[:, 1:], (0, s_pad - s + 1))
    mask = torch.arange(s_pad, device=x.device) < (s - 1)
    remat = torch.is_grad_enabled()

    def one(xc, tc, mc):
        lg = (xc @ head.to(xc.dtype)).float()
        return torch.sum(_vocab_nll(lg, tc, mesh, lay.tp, off) * mc[None, :])

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        a = (x[:, sl], tgt[:, sl], mask[sl])
        total = total + (checkpoint(one, *a, use_reentrant=False,
                                    preserve_rng_state=False)
                         if remat else one(*a))
    total = mesh.psum(total, lay.dp)
    return total / (n_global * (s - 1)) + aux


@torch.no_grad()
def prefill(params: Params, tokens: Tensor, cfg: TransformerConfig, mesh,
            attention: Callable = flash_attention
            ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """``Transformer.prefill`` of the rank's tokens (B/dp, S): (the last
    position's logits of the rank's vocabulary columns (B/dp, V/tp) f32,
    the cache of the kv heads it computed, each (L, B/dp, S, k1 - k0,
    dh)).  Attention through the flash kernel's dispatch."""
    lay = layout(cfg, mesh)
    f = Fetch(params, cfg, mesh, ())
    dev = tokens.device
    b, s = tokens.shape
    x = _start(f, tokens, lay, cfg, mesh)
    positions = torch.arange(s, device=dev).expand(b, s)
    freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, dev)
    glob = (b * mesh.axis_size(lay.dp), s)
    shape = (cfg.n_layers, b, s, lay.k1 - lay.k0, cfg.head_dim)
    cache_k = torch.empty(shape, dtype=x.dtype, device=dev)
    cache_v = torch.empty_like(cache_k)
    for i in range(cfg.n_layers):
        x, _, (k, v) = _block(f, i, x, lay, cfg, mesh, positions, freqs,
                              attention, False, glob)
        cache_k[i] = k
        cache_v[i] = v
    last = x[:, -1:]
    if cfg.seq_shard_activations:              # the last position's rank
        last = mesh.all_gather(last, lay.tp, dim=1)[:, -1:]
    last = rmsnorm(last, f.get("ln_f").to(x.dtype))
    logits = (last @ f.get("lm_head").to(x.dtype)).float()
    return logits[:, 0], (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Decode on a sequence-sharded cache
# ---------------------------------------------------------------------------

def _col_gather(f: Fetch, name: str, h: Tensor, lay: Layout) -> Tensor:
    """``h @ W`` of a column-parallel weight (its storage columns), the
    result all-gathered over the model axis."""
    y = h @ f.get(name).to(h.dtype)
    return f.mesh.all_gather(y, lay.tp, dim=-1)


def _row_partial(f: Fetch, name: str, a: Tensor, lay: Layout) -> Tensor:
    """The rank's partial of ``a @ W`` for a row-parallel weight: its
    storage rows against a's matching columns."""
    w = f.get(name)
    r = w.shape[0]
    return a.narrow(-1, lay.t * r, r) @ w.to(a.dtype)


@torch.no_grad()
def decode_step(params: Params, token: Tensor, cache_k: Tensor,
                cache_v: Tensor, cache_len: Tensor, cfg: TransformerConfig,
                mesh, batch_axes: Tuple[str, ...],
                seq_axes: Tuple[str, ...]) -> Tuple[Tensor, Tuple]:
    """``Transformer.decode_step`` of the rank's rows: token (B_l,), the
    rank's cache slice (L, B_l, S_l, KH_l, dh) of a cache laid out by
    ``cache_specs`` (batch over ``batch_axes``, sequence over
    ``seq_axes``, or kv heads over the model axis: then KH_l < KH),
    cache_len (B_l,).  Writes the new position in place on the rank that
    holds it; returns (the logits of the rank's vocabulary columns (B_l,
    V/tp) f32, the cache)."""
    lay = layout(cfg, mesh)
    f = Fetch(params, cfg, mesh, ())
    dev = token.device
    bl = token.shape[0]
    sl, khl = cache_k.shape[2], cache_k.shape[3]
    off = mesh.index(seq_axes) * sl
    dh, kh = cfg.head_dim, cfg.n_kv_heads
    rep = cfg.n_heads // kh
    heads_local = khl != kh          # kv heads over the model axis
    hl = khl * rep
    x = mesh.psum(_embed_partial(f, token[:, None], cfg.compute_dtype),
                  lay.tp)                                 # (B_l, 1, D)
    freqs = rope_frequencies(dh, cfg.rope_theta, dev)
    positions = cache_len[:, None]
    bidx = torch.arange(bl, device=dev)
    lpos = cache_len.long() - off
    mine = (lpos >= 0) & (lpos < sl)
    lpos = lpos.clamp(0, sl - 1)
    kpos = torch.arange(sl, device=dev)[None, :] + off
    valid = kpos < (cache_len[:, None] + 1)
    scale = 1.0 / math.sqrt(dh)
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        hn = rmsnorm(x, f.get(pre + "ln1").to(x.dtype))
        q, k, v = (hn @ f.get(pre + w).to(x.dtype) for w in ("wq", "wk",
                                                              "wv"))
        if cfg.qkv_bias:
            q = q + f.get(pre + "bq").to(x.dtype)
            k = k + f.get(pre + "bk").to(x.dtype)
            v = v + f.get(pre + "bv").to(x.dtype)
        if not heads_local:          # column shards -> every head
            q, k, v = (mesh.all_gather(t, lay.tp, dim=-1)
                       for t in (q, k, v))
        q = apply_rope(q.reshape(bl, 1, hl, dh), positions, freqs)
        k = apply_rope(k.reshape(bl, 1, khl, dh), positions, freqs)
        v = v.reshape(bl, 1, khl, dh)
        ck, cv = cache_k[i], cache_v[i]
        for c, new in ((ck, k), (cv, v)):
            cur = c[bidx, lpos]
            c[bidx, lpos] = torch.where(mine[:, None, None],
                                        new[:, 0].to(c.dtype), cur)
        qh = q[:, 0].reshape(bl, khl, rep, dh).float()
        sc = torch.einsum("bkrd,bskd->bksr", qh, ck.float()) * scale
        sc = torch.where(valid[:, None, :, None], sc, NEG_INF)
        m = mesh.pmax(torch.amax(sc, dim=2), seq_axes)     # (B_l, KH, rep)
        p = torch.exp(sc - m[:, :, None, :])
        den = mesh.psum(torch.sum(p, dim=2), seq_axes)
        w = p / den[:, :, None, :]     # the softmax, rounded as the port's
        att = mesh.psum(torch.einsum("bksr,bskd->bkrd",
                                     w.to(cv.dtype).float(), cv.float()),
                        seq_axes)
        att = att.reshape(bl, 1, hl * dh).to(x.dtype)
        if heads_local:
            o = att @ f.get(pre + "wo").to(x.dtype)
        else:
            o = _row_partial(f, pre + "wo", att, lay)
        x = x + mesh.psum(o, lay.tp)
        h2 = rmsnorm(x, f.get(pre + "ln2").to(x.dtype))
        fo, _ = _ffn_partial(f, i, h2, lay, cfg, mesh, lambda t, inv: t)
        x = x + mesh.psum(fo, lay.tp)
    x = rmsnorm(x, f.get("ln_f").to(x.dtype))
    logits = (x @ f.get("lm_head").to(x.dtype)).float()
    return logits[:, 0], (cache_k, cache_v)
