"""The JAX package's ``models/layers.py`` in PyTorch: the LM half (norm,
rotary embedding, the training attention ``flash_attention``, decode
attention) and the MLP and embedding half of the recsys models
(``init_mlp``, ``apply_mlp``, ``embedding_bag``, and ``take_fill``,
``jnp.take``'s default gather).

Conventions kept from the reference: weights are used as ``x @ W`` with
``W`` of shape ``(d_in, d_out)``; the parameter dtype and the compute
dtype are separate, and every use casts a weight to the compute dtype
first; reductions that the reference asks in f32 are taken in f32.
``spec_mlp`` waits for the sharding specs.

The GNN's segment reductions (``segment_sum``, ``segment_max``,
``segment_softmax``) take their rows grouped by segment, each segment
reduced in row order by one thread per (segment, column), with no
atomics: the same inputs give the same bits on every run, on the card
as on the CPU.  ``index_add_`` and ``scatter_add_`` would sum with
atomics on the card, in no fixed order.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

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


# ---------------------------------------------------------------------------
# Training attention (blockwise online softmax, autograd)
# ---------------------------------------------------------------------------

def _attn_tile(m_run, l_run, o_run, qb, kb, vb, mask, scale: float,
               grouped: bool):
    """One (q-block, k-block) tile folded into the running (max, sum,
    output): the reference's ``_attn_block`` (``_attn_block_grouped``)
    and its scan step.  Scores in f32 from f32 copies of the operands
    (exact: the reference's ``preferred_element_type=f32``), masked to
    -1e30, p rounded to v's dtype before the PV product."""
    if grouped:      # q (b, qb, g, r, d) against unrepeated k/v (b, kb, g, d)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qb.float(), kb.float()) * scale
        s = torch.where(mask[:, None], s, NEG_INF)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * scale
        s = torch.where(mask, s, NEG_INF)
    m_blk = torch.amax(s, dim=-1)
    p = torch.exp(s - m_blk[..., None])
    l_blk = torch.sum(p, dim=-1)
    pv = "bgrqk,bkgd->bqgrd" if grouped else "bhqk,bkhd->bqhd"
    o_blk = torch.einsum(pv, p.to(vb.dtype).float(), vb.float())
    m_new = torch.maximum(m_run, m_blk)
    a1 = torch.exp(m_run - m_new)
    a2 = torch.exp(m_blk - m_new)
    # (b, g, r, q) -> (b, q, g, r, 1), or (b, h, q) -> (b, q, h, 1)
    perm = (0, 3, 1, 2) if grouped else (0, 2, 1)
    return (m_new, l_run * a1 + l_blk * a2,
            o_run * a1.permute(perm)[..., None]
            + o_blk * a2.permute(perm)[..., None])


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    q_block: int = 512, k_block: int = 1024,
                    grouped: bool = False) -> Tensor:
    """The reference's blockwise attention (``layers.flash_attention``),
    the one its training path runs, in plain PyTorch with autograd (not
    the CUDA kernel, which has no backward).  q: (B, Sq, H, dh); k/v:
    (B, Sk, KH, dh), H % KH == 0; query and key positions both start at
    0 (the reference's ``q_offset``, which no caller of the port sets).

    Every (q-block, k-block) tile is computed, the fully masked ones too,
    with a running max, sum and f32 output per query block; the sum is
    floored at 1e-20 and the output cast to q's dtype.  ``grouped``
    contracts against the unrepeated K/V; otherwise K/V are repeated to H
    heads first.  With gradients on, each tile runs under
    ``torch.utils.checkpoint``, so the backward recomputes its scores (the
    reference's inner ``jax.checkpoint``): autograd keeps no (qb, kb)
    tile of scores."""
    b, sq, h, dh = q.shape
    _, sk, kh, _ = k.shape
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    rep = h // kh
    if not grouped and rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(dh)
    q_block, k_block = min(q_block, sq), min(k_block, sk)
    nq, nk = -(-sq // q_block), -(-sk // k_block)
    sq_pad, sk_pad = nq * q_block, nk * k_block
    q = F.pad(q, (0, 0, 0, 0, 0, sq_pad - sq))
    k = F.pad(k, (0, 0, 0, 0, 0, sk_pad - sk))
    v = F.pad(v, (0, 0, 0, 0, 0, sk_pad - sk))
    dev = q.device
    qpos = torch.arange(sq_pad, device=dev).reshape(nq, q_block)
    kpos = torch.arange(sk_pad, device=dev).reshape(nk, k_block)
    kvalid = (torch.arange(sk_pad, device=dev) < sk).reshape(nk, k_block)
    lead = (b, kh, rep) if grouped else (b, h)
    remat = torch.is_grad_enabled()

    def tile(*a):
        if remat:
            return checkpoint(_attn_tile, *a, scale, grouped,
                              use_reentrant=False, preserve_rng_state=False)
        return _attn_tile(*a, scale, grouped)

    outs = []
    for qi in range(nq):
        qb = q[:, qi * q_block:(qi + 1) * q_block]
        if grouped:
            qb = qb.reshape(b, q_block, kh, rep, dh)
        m = torch.full((*lead, q_block), NEG_INF, device=dev)
        l = torch.zeros((*lead, q_block), device=dev)       # noqa: E741
        o = torch.zeros((b, q_block, *lead[1:], dh), device=dev)
        for ki in range(nk):
            mask = kvalid[ki][None, None, None, :]
            if causal:
                cm = qpos[qi][:, None] >= kpos[ki][None, :]
                mask = mask & cm[None, None]
            ks = slice(ki * k_block, (ki + 1) * k_block)
            m, l, o = tile(m, l, o, qb, k[:, ks], v[:, ks], mask)
        perm = (0, 3, 1, 2) if grouped else (0, 2, 1)
        denom = torch.clamp(l, min=1e-20).permute(perm)[..., None]
        outs.append((o / denom).reshape(b, q_block, h, dh))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


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


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """A plain MLP tower's weights in the reference's tree: ``w[i]`` of
    shape ``(dims[i], dims[i + 1])`` and ``b[i]`` of ``(dims[i + 1],)``.
    With a ``generator`` the weights are drawn on its device with std
    ``1/sqrt(dims[i])`` and the biases are zero; without one they are
    left unset on ``device``, for loading."""

    def __init__(self, dims: Sequence[int], *,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        pairs = list(zip(dims[:-1], dims[1:]))
        if generator is not None:
            device = generator.device
            w = [dense_init(generator, p, 0, dtype) for p in pairs]
        else:
            w = [torch.empty(p, dtype=dtype, device=device) for p in pairs]
        self.w = nn.ParameterList(nn.Parameter(t, requires_grad=False)
                                  for t in w)
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(o, dtype=dtype, device=device),
                         requires_grad=False) for _, o in pairs)


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             dtype=torch.float32) -> MLP:
    """Plain MLP tower: dims = (in, h1, ..., out)."""
    return MLP(dims, generator=generator, dtype=dtype)


def apply_mlp(params: MLP, x: Tensor,
              act: Callable[[Tensor], Tensor] = torch.relu,
              final_act: bool = False) -> Tensor:
    """``x @ w + b`` per layer, ``act`` after every layer but the last
    (and after the last too when ``final_act``)."""
    n = len(params.w)
    for i, (w, b) in enumerate(zip(params.w, params.b)):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# Gathers and the embedding bag
# ---------------------------------------------------------------------------

def fill_rows(ids: Tensor, v: int):
    """``jnp.take``'s default ("fill") indexing of a V-row table: (the
    rows to read, clipped into ``[0, V)``, as int64; which ids are in
    range).  An id in ``[-V, -1]`` wraps to ``V + id``; any other id
    outside ``[0, V)`` is out of range."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    return ids.clamp(0, v - 1), (ids >= 0) & (ids < v)


def take_fill(table: Tensor, ids: Tensor) -> Tensor:
    """Rows ``table[ids]`` with ``jnp.take``'s default ("fill") semantics,
    which every gather of the reference's recsys models outside
    ``embedding_bag`` has (``fill_rows``); an out-of-range id reads a row
    of NaN.  The gather only sees clipped rows, so no unchecked id
    reaches the card's indexing (a device-side assert)."""
    rows, ok = fill_rows(ids, table.shape[0])
    out = table.index_select(0, rows.reshape(-1))
    out = out.reshape(*ids.shape, *table.shape[1:])
    return out.masked_fill_(~ok.reshape(*ids.shape,
                                        *(1,) * (table.dim() - 1)),
                            float("nan"))


def embedding_bag(table: Tensor, ids: Tensor, *, mode: str = "sum",
                  weights: Optional[Tensor] = None,
                  valid: Optional[Tensor] = None) -> Tensor:
    """Gather and reduce over the last axis of ``ids``: (..., n) -> (...,
    D), as the reference's: ids clip into ``[0, V - 1]`` (an id past the
    table reads its last row, a negative id row 0), rows are scaled by
    ``weights``, rows where ``valid`` is False are zeroed, and ``mean``
    divides by ``max(count of valid, 1)`` (by n without ``valid``)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    v = table.shape[0]
    flat = ids.long().clamp(0, v - 1).reshape(-1)
    vecs = table.index_select(0, flat).reshape(*ids.shape, table.shape[1])
    if weights is not None:
        vecs = vecs * weights[..., None]
    if valid is not None:
        vecs = torch.where(valid[..., None], vecs, 0.0)
    out = torch.sum(vecs, dim=-2)
    if mode == "mean":
        if valid is None:
            return out / max(ids.shape[-1], 1)
        out = out / torch.clamp(torch.sum(valid, dim=-1, keepdim=True),
                                min=1)
    return out


# ---------------------------------------------------------------------------
# Segment reductions (the GNN's message passing)
# ---------------------------------------------------------------------------

def sort_segments(segment_ids: Tensor, num_segments: int
                  ) -> Tuple[Tensor, Tensor]:
    """(the stable order that sorts ``segment_ids``, each segment's
    length as int64): rows taken in that order are grouped by segment and
    keep their order inside it."""
    order = torch.argsort(segment_ids, stable=True)
    lengths = torch.bincount(segment_ids, minlength=num_segments)
    return order, lengths


def reduce_sorted(data: Tensor, lengths: Tensor, reduce: str) -> Tensor:
    """``reduce`` ("sum" or "max") over each segment of ``data``'s rows,
    which lie grouped by segment, ``lengths[i]`` rows of segment i after
    those of segment i - 1.  An empty segment sums to 0 and maxes to
    -inf.  Rows are made at least 2-D so every segment is reduced in row
    order (one-dimensional data would take a tree reduction)."""
    flat = data.reshape(data.shape[0], -1)
    initial = 0.0 if reduce == "sum" else float("-inf")
    out = torch.segment_reduce(flat, reduce, lengths=lengths, axis=0,
                               unsafe=True, initial=initial)
    return out.reshape(lengths.shape[0], *data.shape[1:])


def segment_sum(data: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    """``jax.ops.segment_sum`` in a fixed order: each segment's rows
    summed in the order they come in ``data``."""
    order, lengths = sort_segments(segment_ids, num_segments)
    return reduce_sorted(data[order], lengths, "sum")


def segment_max(data: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    """``jax.ops.segment_max``: -inf for an empty segment."""
    order, lengths = sort_segments(segment_ids, num_segments)
    return reduce_sorted(data[order], lengths, "max")


def segment_softmax(scores: Tensor, segment_ids: Tensor,
                    num_segments: int) -> Tensor:
    """Softmax over variable-size groups (the GNN edge softmax): the
    segment max (0 for an empty segment) subtracted, and the sum floored
    at 1e-20, as the reference's."""
    order, lengths = sort_segments(segment_ids, num_segments)
    smax = reduce_sorted(scores[order], lengths, "max")
    smax = torch.nan_to_num(smax, neginf=0.0)
    ex = torch.exp(scores - smax[segment_ids])
    denom = reduce_sorted(ex[order], lengths, "sum")
    return ex / torch.clamp(denom[segment_ids], min=1e-20)
