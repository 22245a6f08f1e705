"""The LM half of the JAX package's ``models/layers.py``, in PyTorch.

Conventions kept from the reference: weights are used as ``x @ W`` with
``W`` of shape ``(d_in, d_out)``; the parameter dtype and the compute
dtype are separate, and every use casts a weight to the compute dtype
first; reductions that the reference asks in f32 are taken in f32.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import NEG_INF

Tensor = torch.Tensor


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> Tensor:
    """Normal weights with std ``1/sqrt(fan_in)``, drawn in ``dtype`` on
    the generator's device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).mul_(std)


def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale``: the sum of squares in f32,
    the products in x's dtype, as the reference orders them."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv[..., None] * scale.to(x.dtype)


def rope_frequencies(d_head: int, theta: float = 10_000.0,
                     device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: Tensor, positions: Tensor, freqs: Tensor) -> Tensor:
    """x: (..., S, H, dh); positions: (..., S).  Rotates the interleaved
    pairs ``(x[..., 0::2], x[..., 1::2])`` by f32 angles and casts the
    result back to x's dtype."""
    angles = positions[..., :, None, None].float() * freqs[None, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    out = torch.stack([out1, out2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_len: Tensor) -> Tensor:
    """Single-position decode: q (B, 1, H, dh) against a (B, S, K, dh)
    cache whose first ``cache_len[b]`` positions are valid.  Products in
    f32, the softmax weights rounded to the cache's dtype before the PV
    product, the output in q's dtype."""
    b, _, h, dh = q.shape
    _, s, kh, _ = k_cache.shape
    rep = h // kh
    scale = 1.0 / math.sqrt(dh)
    qh = q[:, 0].reshape(b, kh, rep, dh).float()
    scores = torch.einsum("bkrd,bskd->bksr", qh, k_cache.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]
    scores = torch.where(valid[:, None, :, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=2)
    out = torch.einsum("bksr,bskd->bkrd", w.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)
