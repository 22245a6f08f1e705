"""Decoder-only transformer LM (dense + MoE), GQA, RoPE, flash attention:
the JAX package's ``models/transformer.py`` in PyTorch.

Paths:
  * ``Transformer.prefill``     — full-prompt forward; emits the KV cache
                                  (attention through the hand-written
                                  flash kernel on the card)
  * ``Transformer.decode_step`` — one token against the KV cache
  * ``forward_train``, ``hidden_states``, ``lm_loss``,
    ``lm_loss_chunked`` — the training forward and losses, with
                                  autograd, through the plain blockwise
                                  attention (``layers.flash_attention``),
                                  as the reference trains
  * ``moe_ffn``                 — the GShard top-k MoE FFN with capacity
                                  that all of them run on an MoE config

Weights keep the reference's orientation (``x @ W``, ``W`` as
``(d_in, d_out)``) and its cache layout ``(L, B, S, KH, dh)``.  The
sharding specs (``param_specs``, ``cache_specs``, ``_act_specs``) are
the reference's, keyed by the port's parameter names (a layer-stacked
leaf's spec loses its layer axis); ``models/spmd.py`` runs one rank's
part of these models on a mesh by them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..kernels.flash_attention import flash_attention
from ..launch.mesh import P, shard_shape
from .layers import (apply_rope, decode_attention, dense_init, rmsnorm,
                     rope_frequencies)
from .layers import flash_attention as train_attention

Tensor = torch.Tensor


@dataclass(frozen=True)
class MoEConfig:
    """The reference's MoE fields; its ``impl`` switch is dropped: the
    port has one dispatch (``moe_ffn``)."""
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    group_size: int = 512
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class TransformerConfig:
    """The reference's model fields but ``attn_impl``: serving always
    runs the flash kernel on the card, against unrepeated K/V.
    ``remat`` and ``attn_grouped`` steer training only (one checkpoint per
    layer; the training attention's grouped or repeat path).  The mesh
    fields (``dp_axes``, ``tp_axis``, ``seq_shard_activations``) steer
    only the sharding specs and ``models/spmd.py``."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    moe: Optional[MoEConfig] = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    q_block: int = 512             # tiles of the plain attention
    k_block: int = 1024
    attn_grouped: bool = False
    # mesh axis groups
    dp_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: str = "model"
    seq_shard_activations: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads


def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One decoder layer's weights (the reference's per-layer slice of
    its layer-stacked tree)."""

    def __init__(self, cfg: TransformerConfig, make):
        super().__init__()
        d, h, kh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh, f = cfg.head_dim, cfg.d_ff
        self.ln1 = _param(make("ones", (d,)))
        self.ln2 = _param(make("ones", (d,)))
        self.wq = _param(make("dense", (d, h * dh)))
        self.wk = _param(make("dense", (d, kh * dh)))
        self.wv = _param(make("dense", (d, kh * dh)))
        self.wo = _param(make("dense", (h * dh, d)))
        if cfg.qkv_bias:
            self.bq = _param(make("zeros", (h * dh,)))
            self.bk = _param(make("zeros", (kh * dh,)))
            self.bv = _param(make("zeros", (kh * dh,)))
        if cfg.moe is None:
            self.w_gate = _param(make("dense", (d, f)))
            self.w_up = _param(make("dense", (d, f)))
            self.w_down = _param(make("dense", (f, d)))
            return
        self.moe = MoE(cfg, make)
        if cfg.moe.n_shared:
            self.shared_mlp = SharedMLP(d, cfg.moe.d_ff * cfg.moe.n_shared,
                                        make)


class MoE(nn.Module):
    """One layer's routed experts: ``router (d, E)``, ``w_gate``/``w_up
    (E, d, fe)`` and ``w_down (E, fe, d)``, each expert's std from its
    own fan-in, as the reference draws them."""

    def __init__(self, cfg: TransformerConfig, make):
        super().__init__()
        d, e, fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
        self.router = _param(make("dense", (d, e)))
        self.w_gate = _param(make("dense", (e, d, fe), 1))
        self.w_up = _param(make("dense", (e, d, fe), 1))
        self.w_down = _param(make("dense", (e, fe, d), 1))


class SharedMLP(nn.Module):
    """The always-on experts of one layer, as one SwiGLU of width
    ``d_ff * n_shared``."""

    def __init__(self, d: int, f: int, make):
        super().__init__()
        self.w_gate = _param(make("dense", (d, f)))
        self.w_up = _param(make("dense", (d, f)))
        self.w_down = _param(make("dense", (f, d)))


def _qkv(lp: Block, x: Tensor, cfg: TransformerConfig):
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = x @ lp.wq.to(x.dtype)
    kk = x @ lp.wk.to(x.dtype)
    v = x @ lp.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + lp.bq.to(x.dtype)
        kk = kk + lp.bk.to(x.dtype)
        v = v + lp.bv.to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, dh),
            kk.reshape(b, s, cfg.n_kv_heads, dh),
            v.reshape(b, s, cfg.n_kv_heads, dh))


def swiglu(x: Tensor, w: Callable[[str], Tensor]) -> Tensor:
    """SwiGLU of x in x's dtype through ``w("w_gate")``, ``w("w_up")``
    and ``w("w_down")``, each weight fetched where it is used (a rank's
    program gathers it there)."""
    h = F.silu(x @ w("w_gate").to(x.dtype)) * (x @ w("w_up").to(x.dtype))
    return h @ w("w_down").to(x.dtype)


def _swiglu(p, x: Tensor) -> Tensor:
    """SwiGLU through ``p.w_gate``, ``p.w_up`` and ``p.w_down``."""
    return swiglu(x, lambda n: getattr(p, n))


@dataclass
class Routing:
    """Where ``route`` sends each (token, choice) pair of one MoE layer."""
    xg: Tensor      # (ng, g, d) the tokens in groups, the last zero-padded
    top_w: Tensor   # (ng, g, k) f32 gate weights, renormalised
    top_e: Tensor   # (ng, g, k) int64 experts, most probable first
    slot: Tensor    # (ng, g, k) int64 place in the expert's queue
    cap: int        # slots an expert has per group; slot >= cap: dropped
    aux: Tensor     # f32 scalar, the Switch load-balancing term
    me: Tensor      # (E,) f32 mean router probabilities over the rows
    ce: Tensor      # (E,) f32 share of rows whose first choice is e


def route(moe: MoE, x: Tensor, mcfg: MoEConfig) -> Routing:
    """The reference's routing of x (B, S, d): the flattened tokens in
    groups of ``g = min(group_size, B*S)`` (the last zero-padded; the
    padding routes too, after every real token of its group), f32
    logits from f32 copies of the x-dtype operands, an f32 softmax, the
    top k by a stable descending sort (ties to the lower expert, as
    ``lax.top_k``), weights renormalised by ``max(sum, 1e-9)``, and each
    pair's slot from a cumsum over the group's pairs in token-major
    order."""
    b, s, d = x.shape
    e, k = mcfg.n_experts, mcfg.top_k
    t = b * s
    g = min(mcfg.group_size, t)
    ng = -(-t // g)
    xf = x.reshape(t, d)
    if ng * g != t:
        xf = F.pad(xf, (0, 0, 0, ng * g - t))
    xg = xf.reshape(ng, g, d)
    logits = xg.float() @ moe.router.to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_e[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(me * ce) * mcfg.router_aux_weight
    cap = int(math.ceil(g * k * mcfg.capacity_factor / e / 4.0) * 4)
    pairs = top_e.reshape(ng, g * k, 1)
    seen = F.one_hot(pairs[..., 0], e).cumsum(1)          # (ng, g*k, E)
    slot = (torch.gather(seen, 2, pairs) - 1).reshape(ng, g, k)
    return Routing(xg, top_w, top_e, slot, cap, aux, me, ce)


def moe_ffn(moe: MoE, x: Tensor, cfg: TransformerConfig
            ) -> Tuple[Tensor, Tensor]:
    """The reference's GShard top-k MoE with capacity (``moe_ffn``):
    x (B, S, d) -> (out (B, S, d) in x's dtype, aux f32 scalar): ``route``,
    then ``moe_experts`` over every expert."""
    r = route(moe, x, cfg.moe)
    return moe_experts(r, lambda n: getattr(moe, n), x.shape), r.aux


def moe_experts(r: Routing, w: Callable[[str], Tensor], shape,
                e0: int = 0) -> Tensor:
    """The dispatch, experts and combine of ``moe_ffn`` for the routing
    ``r`` of tokens of ``shape`` (B, S, d), restricted to the experts
    [e0, e0 + E_l) whose weights ``w("w_gate")``, ``w("w_up")`` (E_l, d,
    f) and ``w("w_down")`` (E_l, f, d) are; a rank of the expert-parallel
    program passes its own, the one-device model all of them.

    The reference dispatches and combines by one-hot einsums over a
    ``(g, E, C)`` slot tensor; here each kept pair's row is gathered into
    an ``(E_l, ng * cap, d)`` buffer (zero where a slot is empty), the
    experts run as batched products in x's dtype, and each token adds its
    kept pairs' ``gate.to(x.dtype) * eout`` in f32, choice by choice, then
    casts to x's dtype.  A pair past its expert's capacity, or sent to an
    expert outside the range, adds nothing: a token that loses every
    choice gets zeros."""
    b, s, d = shape
    xg = r.xg
    dt, dev = xg.dtype, xg.device
    ng, g, k = r.top_e.shape
    w_gate = w("w_gate")
    el, cap = w_gate.shape[0], r.cap
    keep = (r.slot < cap) & (r.top_e >= e0) & (r.top_e < e0 + el)
    grp = torch.arange(ng, device=dev)[:, None, None]
    row = ((r.top_e - e0) * ng + grp) * cap + r.slot   # expert-major rows
    # which token fills each buffer row (ng * g: the zero row past the
    # tokens); the dropped pairs all write one spare entry, cut off after
    n_rows = el * ng * cap
    src = torch.full((n_rows + 1,), ng * g, dtype=torch.long, device=dev)
    tok = (grp * g + torch.arange(g, device=dev)[None, :, None]).expand(
        ng, g, k)
    src.scatter_(0, torch.where(keep, row, n_rows).reshape(-1),
                 tok.reshape(-1))
    xz = torch.cat([xg.reshape(ng * g, d), xg.new_zeros((1, d))])
    ein = xz[src[:n_rows]].reshape(el, ng * cap, d)
    hg = torch.bmm(ein, w_gate.to(dt))
    hu = torch.bmm(ein, w("w_up").to(dt))
    eout = torch.bmm(F.silu(hg) * hu, w("w_down").to(dt))
    eout = eout.reshape(n_rows, d)
    gate = torch.where(keep, r.top_w, 0.0).to(dt).reshape(ng * g, k)
    row = torch.where(keep, row, 0).reshape(ng * g, k)
    acc = torch.zeros((ng * g, d), dtype=torch.float32, device=dev)
    for j in range(k):
        acc += gate[:, j, None].float() * eout[row[:, j]].float()
    return acc.to(dt)[:b * s].reshape(b, s, d)


def _ffn(lp: Block, x: Tensor, cfg: TransformerConfig
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's FFN: (the dense SwiGLU, None), or (the MoE plus the
    shared experts, the MoE's aux term)."""
    if cfg.moe is None:
        return _swiglu(lp, x), None
    out, aux = moe_ffn(lp.moe, x, cfg)
    if cfg.moe.n_shared:
        out = out + _swiglu(lp.shared_mlp, x)
    return out, aux


class Transformer(nn.Module):
    """The LM's weights on one device, in ``cfg.param_dtype``, drawn from
    ``generator`` (on ``device``; a fresh one seeded with 0 by default) with
    the reference's ``1/sqrt(fan_in)`` std, norms at one and biases at
    zero.  ``init=False`` leaves the weights unset, for loading
    (``convert.params_from_jax``).  An MoE config whose ``top_k`` is not
    in ``[1, n_experts]`` raises ValueError."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        if cfg.moe is not None and not 0 < cfg.moe.top_k <= \
                cfg.moe.n_experts:
            raise ValueError(f"MoE top_k {cfg.moe.top_k} is not in [1, "
                             f"n_experts = {cfg.moe.n_experts}]")
        dev = resolve_device(device)
        if init and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        dt = cfg.param_dtype

        def make(kind, shape, in_axis=0):
            if not init:
                return torch.empty(shape, dtype=dt, device=dev)
            if kind == "dense":
                return dense_init(generator, shape, in_axis, dt)
            fill = torch.ones if kind == "ones" else torch.zeros
            return fill(shape, dtype=dt, device=dev)

        self.cfg = cfg
        self.embed = _param(make("dense", (cfg.vocab_size, cfg.d_model), 1))
        self.blocks = nn.ModuleList(Block(cfg, make)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _param(make("ones", (cfg.d_model,)))
        self.lm_head = _param(make("dense", (cfg.d_model, cfg.vocab_size)))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _logits(self, x: Tensor) -> Tensor:
        x = rmsnorm(x, self.ln_f.to(x.dtype))
        return (x @ self.lm_head.to(x.dtype)).float()

    @torch.no_grad()
    def prefill(self, tokens: Tensor, attention: Callable = flash_attention
                ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """tokens (B, S) -> (last-position logits (B, V) f32, KV cache
        (k, v), each (L, B, S, KH, dh) in the compute dtype).
        ``attention(q, k, v, causal=, q_block=, k_block=)`` is the flash
        kernel's dispatch unless a caller checks or captures it."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        x = self.embed[tokens].to(cfg.compute_dtype)
        positions = torch.arange(s, device=self.device).expand(b, s)
        freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, self.device)
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        cache_k = torch.empty(shape, dtype=x.dtype, device=self.device)
        cache_v = torch.empty_like(cache_k)
        for i, lp in enumerate(self.blocks):
            h = rmsnorm(x, lp.ln1.to(x.dtype))
            q, k, v = _qkv(lp, h, cfg)
            q = apply_rope(q, positions, freqs)
            k = apply_rope(k, positions, freqs)
            att = attention(q, k, v, causal=True, q_block=cfg.q_block,
                            k_block=cfg.k_block)
            att = att.reshape(b, s, cfg.n_heads * cfg.head_dim)
            x = x + att @ lp.wo.to(x.dtype)
            x = x + _ffn(lp, rmsnorm(x, lp.ln2.to(x.dtype)), cfg)[0]
            cache_k[i] = k
            cache_v[i] = v
        return self._logits(x[:, -1:])[:, 0], (cache_k, cache_v)

    @torch.no_grad()
    def decode_step(self, token: Tensor, cache_k: Tensor, cache_v: Tensor,
                    cache_len: Tensor
                    ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """One decode step.  token (B,); cache (L, B, S, KH, dh);
        cache_len (B,) current lengths, below S.
        Linear in S.  Unlike the reference, which returns new arrays, the
        step writes the new position into ``cache_k``/``cache_v`` in place
        (a serving cache is too large to copy per token) and returns
        them."""
        cfg = self.cfg
        dev = self.device
        token, cache_len = token.to(dev), cache_len.to(dev)
        x = self.embed[token[:, None]].to(cfg.compute_dtype)   # (B, 1, D)
        freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, dev)
        positions = cache_len[:, None]
        bidx = torch.arange(x.shape[0], device=dev)
        for i, lp in enumerate(self.blocks):
            h = rmsnorm(x, lp.ln1.to(x.dtype))
            q, k, v = _qkv(lp, h, cfg)
            q = apply_rope(q, positions, freqs)
            k = apply_rope(k, positions, freqs)
            ck, cv = cache_k[i], cache_v[i]
            ck[bidx, cache_len] = k[:, 0].to(ck.dtype)
            cv[bidx, cache_len] = v[:, 0].to(cv.dtype)
            att = decode_attention(q, ck, cv, cache_len + 1)
            att = att.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
            x = x + att @ lp.wo.to(x.dtype)
            x = x + _ffn(lp, rmsnorm(x, lp.ln2.to(x.dtype)), cfg)[0]
        return self._logits(x)[:, 0], (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Training: the forward with autograd, and the losses
# ---------------------------------------------------------------------------

def block(lp: Block, x: Tensor, positions: Tensor, cfg: TransformerConfig,
          freqs: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
    """One decoder layer for training: (x out, the MoE aux term or None).
    Attention is the plain blockwise one (``layers.flash_attention``, the
    reference's jnp path), grouped or repeated by ``cfg.attn_grouped``."""
    b, s, _ = x.shape
    h = rmsnorm(x, lp.ln1.to(x.dtype))
    q, k, v = _qkv(lp, h, cfg)
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    att = train_attention(q, k, v, causal=True, q_block=cfg.q_block,
                          k_block=cfg.k_block, grouped=cfg.attn_grouped)
    x = x + att.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp.wo.to(x.dtype)
    f, aux = _ffn(lp, rmsnorm(x, lp.ln2.to(x.dtype)), cfg)
    return x + f, aux


def hidden_states(model: Transformer, tokens,
                  cfg: Optional[TransformerConfig] = None
                  ) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (the final norm's output (B, S, D) in the compute
    dtype, the MoE aux terms summed over the layers, f32).  With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``, which
    saves only its input (the reference's ``nothing_saveable``).  ``cfg``
    defaults to the model's (a replacement must keep its shapes)."""
    cfg = cfg or model.cfg
    dev = model.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape
    x = model.embed[tokens].to(cfg.compute_dtype)
    positions = torch.arange(s, device=dev).expand(b, s)
    freqs = rope_frequencies(cfg.head_dim, cfg.rope_theta, dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in model.blocks:
        if remat:
            x, a = checkpoint(block, lp, x, positions, cfg, freqs,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block(lp, x, positions, cfg, freqs)
        if a is not None:
            aux = aux + a
    return rmsnorm(x, model.ln_f.to(x.dtype)), aux


def forward_train(model: Transformer, tokens,
                  cfg: Optional[TransformerConfig] = None
                  ) -> Tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) f32, aux f32 scalar)."""
    x, aux = hidden_states(model, tokens, cfg)
    return (x @ model.lm_head.to(x.dtype)).float(), aux


def _nll(lg: Tensor, tgt: Tensor) -> Tensor:
    """Per-position ``logsumexp(lg) - lg[tgt]`` of f32 logits."""
    gold = torch.gather(lg, -1, tgt[..., None].long())[..., 0]
    return torch.logsumexp(lg, dim=-1) - gold


def lm_loss(model: Transformer, tokens,
            cfg: Optional[TransformerConfig] = None) -> Tensor:
    """Next-token cross-entropy, the mean over B x (S - 1) positions, plus
    the MoE aux term."""
    logits, aux = forward_train(model, tokens, cfg)
    tgt = torch.as_tensor(tokens, device=logits.device)[:, 1:]
    return torch.mean(_nll(logits[:, :-1], tgt)) + aux


def lm_loss_chunked(model: Transformer, tokens,
                    cfg: Optional[TransformerConfig] = None,
                    chunk: int = 512) -> Tensor:
    """``lm_loss`` without the (B, S, V) logits: the unembedding and the
    cross-entropy run over ``chunk`` positions at a time, each chunk under
    ``torch.utils.checkpoint`` (its logits recomputed in the backward).
    As the reference: the targets shifted by one and zero-padded, the
    sequence padded to whole chunks, the last position and the padding
    masked, the chunk sums added in order, and the total divided by
    B x (S - 1)."""
    x, aux = hidden_states(model, tokens, cfg)
    b, s, _ = x.shape
    tokens = torch.as_tensor(tokens, device=x.device).long()
    n_chunks = -(-s // chunk)
    s_pad = n_chunks * chunk
    x = F.pad(x, (0, 0, 0, s_pad - s))
    tgt = F.pad(tokens[:, 1:], (0, s_pad - s + 1))
    mask = torch.arange(s_pad, device=x.device) < (s - 1)
    remat = torch.is_grad_enabled()

    def one(xc, tc, mc):
        lg = (xc @ model.lm_head.to(xc.dtype)).float()
        return torch.sum(_nll(lg, tc) * mc[None, :])

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        args = (x[:, sl], tgt[:, sl], mask[sl])
        total = total + (checkpoint(one, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if remat else one(*args))
    return total / (b * (s - 1)) + aux


def param_count(cfg: TransformerConfig) -> int:
    """Analytic parameter count (as the reference's, MoE included)."""
    d, dh = cfg.d_model, cfg.head_dim
    attn = d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * d
    if cfg.moe is None:
        ffn = 3 * d * cfg.d_ff
    else:
        ffn = cfg.moe.n_experts * 3 * d * cfg.moe.d_ff + d * cfg.moe.n_experts
        ffn += cfg.moe.n_shared * 3 * d * cfg.moe.d_ff
    per_layer = attn + ffn + 2 * d
    return cfg.n_layers * per_layer + 2 * cfg.vocab_size * d + d


def active_param_count(cfg: TransformerConfig) -> int:
    """Active (per-token) parameters: MoE counts top_k + shared experts."""
    if cfg.moe is None:
        return param_count(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    attn = d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * d
    ffn = (cfg.moe.top_k + cfg.moe.n_shared) * 3 * d * cfg.moe.d_ff \
        + d * cfg.moe.n_experts
    per_layer = attn + ffn + 2 * d
    return cfg.n_layers * per_layer + 2 * cfg.vocab_size * d + d



# ---------------------------------------------------------------------------
# Sharding specs (the reference's, by the port's parameter names)
# ---------------------------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> dict:
    """Parameter name -> ``P``: weights FSDP-sharded over ``dp_axes`` and
    tensor-parallel over ``tp_axis``, the routed experts' weights
    expert-parallel over ``tp_axis``, norms replicated."""
    dp, tp = cfg.dp_axes, cfg.tp_axis
    blk = {"ln1": P(None), "ln2": P(None), "wq": P(dp, tp),
           "wk": P(dp, tp), "wv": P(dp, tp), "wo": P(tp, dp)}
    if cfg.qkv_bias:
        blk.update(bq=P(tp), bk=P(tp), bv=P(tp))
    mlp = {"w_gate": P(dp, tp), "w_up": P(dp, tp), "w_down": P(tp, dp)}
    if cfg.moe is None:
        blk.update(mlp)
    else:
        blk.update({"moe.router": P(dp, None),
                    "moe.w_gate": P(tp, dp, None),
                    "moe.w_up": P(tp, dp, None),
                    "moe.w_down": P(tp, None, dp)})
        if cfg.moe.n_shared:
            blk.update({f"shared_mlp.{k}": v for k, v in mlp.items()})
    specs = {"embed": P(tp, dp)}
    for i in range(cfg.n_layers):
        specs.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    specs.update(ln_f=P(None), lm_head=P(dp, tp))
    return specs


def param_shapes(cfg: TransformerConfig) -> dict:
    """Parameter name -> full shape, in ``param_specs``' order (the
    shapes ``Transformer`` makes)."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f, v = cfg.d_ff, cfg.vocab_size
    blk = {"ln1": (d,), "ln2": (d,), "wq": (d, h * dh),
           "wk": (d, kh * dh), "wv": (d, kh * dh), "wo": (h * dh, d)}
    if cfg.qkv_bias:
        blk.update(bq=(h * dh,), bk=(kh * dh,), bv=(kh * dh,))
    if cfg.moe is None:
        blk.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    else:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff
        blk.update({"moe.router": (d, e), "moe.w_gate": (e, d, fe),
                    "moe.w_up": (e, d, fe), "moe.w_down": (e, fe, d)})
        if cfg.moe.n_shared:
            fs = fe * cfg.moe.n_shared
            blk.update({"shared_mlp.w_gate": (d, fs),
                        "shared_mlp.w_up": (d, fs),
                        "shared_mlp.w_down": (fs, d)})
    shapes = {"embed": (v, d)}
    for i in range(cfg.n_layers):
        shapes.update({f"blocks.{i}.{k}": s for k, s in blk.items()})
    shapes.update(ln_f=(d,), lm_head=(d, v))
    return shapes


def cache_specs(cfg: TransformerConfig, seq_shard: bool = False) -> P:
    """The KV cache's (L, B, S, KH, dh) layout: batch over dp; the
    sequence over the model axis when the cache dominates memory
    (decode_32k / long_500k: the flash-decoding layout), else kv heads
    over it."""
    dp, tp = cfg.dp_axes, cfg.tp_axis
    if seq_shard:
        return P(None, dp, tp, None, None)
    return P(None, dp, None, tp, None)


def _act_specs(cfg: TransformerConfig) -> dict:
    """The activations' layouts: the residual (B, S, D) batch over dp and
    sequence over the model axis (Megatron-SP) when
    ``seq_shard_activations``; the heads (B, S, H, dh) over the model
    axis; the MoE dispatch."""
    dp, tp = cfg.dp_axes, cfg.tp_axis
    seq = tp if cfg.seq_shard_activations else None
    return {"resid": P(dp, seq, None), "heads": P(dp, None, tp, None),
            "moe_disp": P(dp, None, tp, None) if cfg.moe else None}


def _constrain(x: Tensor, spec: Optional[P], mesh, shape) -> Tensor:
    """The reference's sharding constraint, as a check: ``x`` (a local
    tensor of a rank's program) must have the shard shape that ``spec``
    gives the global ``shape`` on ``mesh``; raises ValueError if not."""
    if spec is None or mesh is None:
        return x
    want = shard_shape(shape, P(*(a if a is None or isinstance(a, str)
                                  else mesh.present(a) for a in spec)),
                       mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"local shape {tuple(x.shape)} is not the shard "
                         f"{want} of {tuple(shape)} by {spec}")
    return x
