"""Decoder-only transformer LM (dense), GQA, RoPE, flash attention: the
serving path of the JAX package's ``models/transformer.py`` in PyTorch.

Paths:
  * ``Transformer.prefill``     — full-prompt forward; emits the KV cache
                                  (attention through the hand-written
                                  flash kernel on the card)
  * ``Transformer.decode_step`` — one token against the KV cache

Weights keep the reference's orientation (``x @ W``, ``W`` as
``(d_in, d_out)``) and its cache layout ``(L, B, S, KH, dh)``.  Not
ported yet (ROADMAP Queue 1 item 12): the MoE FFN, training
(``forward_train``, the losses, ``hidden_states``) and the sharding
specs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import resolve_device
from ..kernels.flash_attention import flash_attention
from .layers import (apply_rope, decode_attention, dense_init, rmsnorm,
                     rope_frequencies)

Tensor = torch.Tensor

MOE_NOT_PORTED = ("the MoE FFN (moe_ffn) is not ported yet: ROADMAP Queue 1 "
                  "item 12")


@dataclass(frozen=True)
class MoEConfig:
    """The reference's expert counts and widths, which ``param_count``
    reads; its routing fields wait with the MoE FFN."""
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # shared (always-on) experts


@dataclass(frozen=True)
class TransformerConfig:
    """The reference's model fields; its mesh fields (``dp_axes``,
    ``tp_axis``, ``seq_shard_activations``), attention switches
    (``attn_impl``, ``attn_grouped``) and training's ``remat`` are
    dropped: the port serves, always against unrepeated K/V."""
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
    q_block: int = 512             # tiles of the plain attention (CPU)
    k_block: int = 1024

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


def _ffn(lp: Block, x: Tensor) -> Tensor:
    """The dense SwiGLU FFN (the MoE branch is not ported)."""
    h = F.silu(x @ lp.w_gate.to(x.dtype)) * (x @ lp.w_up.to(x.dtype))
    return h @ lp.w_down.to(x.dtype)


class Transformer(nn.Module):
    """The LM's weights on one device, in ``cfg.param_dtype``, drawn from
    ``generator`` (on ``device``; a fresh one seeded with 0 by default) with
    the reference's ``1/sqrt(fan_in)`` std, norms at one and biases at
    zero.  ``init=False`` leaves the weights unset, for loading
    (``convert.params_from_jax``).  A config with ``moe`` raises
    NotImplementedError."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(MOE_NOT_PORTED)
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
            x = x + _ffn(lp, rmsnorm(x, lp.ln2.to(x.dtype)))
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
            x = x + _ffn(lp, rmsnorm(x, lp.ln2.to(x.dtype)))
        return self._logits(x)[:, 0], (cache_k, cache_v)


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

