"""Plain PyTorch oracles for the scan kernels.

Torch twins of the JAX package's ``kernels/ref.py``: the ground truth the
tests hold the kernels' plain versions and the CUDA kernels against, and
the ``impl="torch"`` execution path.  Same contracts: minimization
convention (inner product negated), misses are ``MASK_DIST`` with index
-1, results ascending.

Top-k selection follows ``jax.lax.top_k``: among equal distances the
earlier position wins.  ``_topk_smallest`` gets that from a stable sort,
since ``torch.topk`` leaves the order of ties unspecified.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

# Large-but-finite sentinel: keeps masked lanes inert without NaNs from
# inf - inf.  The same value the JAX package uses.
MASK_DIST = 3.0e38

# The indexed oracle takes queries in blocks of at most this many
# distances, so that a main-path union (~5M rows) fits in memory.
BLOCK_ELEMS = 1 << 27


def _topk_smallest(d: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Ascending top-k of the last axis; ties keep the earlier position."""
    vals, pos = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]


def pairwise_l2_sq(queries: Tensor, xs: Tensor) -> Tensor:
    """Squared L2 distances, (Q, d) x (N, d) -> (Q, N), via
    ||q - x||^2 = ||q||^2 + ||x||^2 - 2 q.x, clamped at 0."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    x2 = torch.sum(xs * xs, dim=-1)
    qx = queries @ xs.T
    return torch.clamp(q2 + x2[None, :] - 2.0 * qx, min=0.0)


def pairwise_ip(queries: Tensor, xs: Tensor) -> Tensor:
    """Inner-product scores, (Q, d) x (N, d) -> (Q, N)."""
    return queries @ xs.T


def scan_distances(queries: Tensor, xs: Tensor, metric: str = "l2",
                   valid: Optional[Tensor] = None, *, with_q2: bool = True
                   ) -> Tensor:
    """Distance matrix in minimization convention; ``valid`` (N,) bool
    sends invalid rows to MASK_DIST.  ``with_q2=False`` leaves ``||q||^2``
    (and the clamp at 0) out of L2, as the scan kernels do."""
    if metric == "l2":
        d = pairwise_l2_sq(queries, xs) if with_q2 else (
            torch.sum(xs * xs, dim=-1)[None, :] - 2.0 * (queries @ xs.T))
    elif metric == "ip":
        d = -pairwise_ip(queries, xs)
    else:
        raise ValueError(f"unknown metric: {metric}")
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.full_like(d, MASK_DIST))
    return d


def scan_topk_ref(queries: Tensor, xs: Tensor, k: int, metric: str = "l2",
                  valid: Optional[Tensor] = None, *, with_q2: bool = True
                  ) -> Tuple[Tensor, Tensor]:
    """Oracle fused scan: ascending top-k (distances, int32 indices into
    ``xs``) per query; masked entries surface as MASK_DIST with index -1.
    Equal distances keep the smaller index."""
    d = scan_distances(queries, xs, metric, valid, with_q2=with_q2)
    dists, idx = _topk_smallest(d, k)
    idx = torch.where(dists >= MASK_DIST, -1, idx)
    return dists, idx.to(torch.int32)


def kmeans_assign_ref(xs: Tensor, centroids: Tensor,
                      valid: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Oracle assignment: nearest centroid (argmin L2, first index on
    ties) per point.  Invalid points (mask False) get -1 / MASK_DIST."""
    d = pairwise_l2_sq(xs, centroids)
    assign = torch.argmin(d, dim=-1).to(torch.int32)
    mind = torch.min(d, dim=-1).values
    if valid is not None:
        assign = torch.where(valid, assign, -1)
        mind = torch.where(valid, mind, torch.full_like(mind, MASK_DIST))
    return assign, mind


def scan_selected_ref(queries: Tensor, data: Tensor, aux_valid: Tensor,
                      sel: Tensor, qmask: Tensor, k: int,
                      metric: str = "l2", *, with_q2: bool = True
                      ) -> Tuple[Tensor, Tensor]:
    """Oracle for the indexed scan: top-k over a union of selected blocks.

    queries (B, d); data (P, S, d); aux_valid (P, S) bool (True = real
    row); sel (U,) partition ids; qmask (B, U) bool (query b wants block
    u).  Returns (dists (B, k) ascending, flat idx = partition*S + slot);
    equal distances keep the earlier union position.  ``with_q2=False``
    leaves ``||q||^2`` (and the clamp at 0) out of L2, as the kernel does.
    Queries go in blocks of at most ``BLOCK_ELEMS`` distances.
    """
    sel = sel.long()
    blocks = data.index_select(0, sel).float()            # (U, S, d)
    valid = aux_valid.index_select(0, sel)                 # (U, S)
    queries = queries.float()
    x2 = torch.sum(blocks * blocks, dim=-1) if metric == "l2" else None
    s = data.shape[1]
    flat_idx = (sel[:, None] * s
                + torch.arange(s, device=sel.device)[None, :]).reshape(-1)
    k_eff = min(k, flat_idx.numel())
    rows = max(1, BLOCK_ELEMS // max(1, flat_idx.numel()))
    out_d = [torch.full((0, k_eff), MASK_DIST, device=data.device)]
    out_i = [torch.full((0, k_eff), -1, dtype=torch.int32,
                        device=data.device)]
    for b0 in range(0, queries.shape[0], rows):
        qb = queries[b0:b0 + rows]
        qx = torch.einsum("usd,bd->bus", blocks, qb)
        if metric == "l2":
            dist = x2[None] - 2.0 * qx
            if with_q2:
                q2 = torch.sum(qb * qb, dim=-1)[:, None, None]
                dist = torch.clamp(dist + q2, min=0.0)
        else:
            dist = -qx
        mask = torch.full_like(dist, MASK_DIST)
        dist = torch.where(valid[None], dist, mask)
        dist = torch.where(qmask[b0:b0 + rows, :, None], dist, mask)
        d_blk, pos = _topk_smallest(dist.reshape(qb.shape[0], -1), k_eff)
        i_blk = torch.where(d_blk >= MASK_DIST, -1, flat_idx[pos])
        out_d.append(d_blk)
        out_i.append(i_blk.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_i)


# ---------------------------------------------------------------------------
# int8 (IVF-residual SQ8) scan
# ---------------------------------------------------------------------------

Q8_SLOTS = 64        # union slots whose codes are widened to f32 at once


def quantize_int8(x: Tensor, axis: int = -1) -> Tuple[Tensor, Tensor]:
    """Symmetric per-row int8 quantization on ``x``'s device: (codes,
    scales) with x ~= codes * scales[..., None].  ``torch.round`` rounds
    half to even, as ``jnp.round`` does, and ``x / scale`` divides as the
    JAX package does (a reciprocal would round differently)."""
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.squeeze(axis)


def quantize_int8_residual(data: Tensor, centroids: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """IVF residual quantization: codes encode ``x - c_j``, whose range is
    the cluster radius rather than the norm.  data (P, S, d), centroids
    (P, d) -> (codes (P, S, d) int8, scales (P, S))."""
    return quantize_int8(data - centroids[:, None, :].to(data.dtype))


def q8_scan_operands(queries: Tensor, codes: Tensor, scales: Tensor,
                     valid: Tensor, sel: Tensor, metric: str = "l2",
                     centroids: Optional[Tensor] = None):
    """The prep around the int8 scan (the JAX package's
    ``_scan_selected_q8_padded``): per-row query codes and scales, ``aux``
    (P, S) = the dequantized ||x^||^2 plus the pad bias (L2) or the bias
    alone (IP), and ``qc`` (B, U) = the exact f32 q . c_sel[u] for
    residual codes (zeros for plain codes).

    ||x^||^2 = ||c||^2 + 2 s (c . r) + s^2 ||r||^2 for residual codes and
    s^2 ||r||^2 for plain ones.  Only the selected partitions' rows of
    ``aux`` are computed (the scan reads no others; the rest stay
    MASK_DIST), ``Q8_SLOTS`` union slots at a time."""
    q_codes, q_scales = quantize_int8(queries.float())
    sel = sel.long()
    p, s, _ = codes.shape
    aux = torch.full((p, s), MASK_DIST, dtype=torch.float32,
                     device=codes.device)
    for u0 in range(0, sel.shape[0], Q8_SLOTS):
        part = sel[u0:u0 + Q8_SLOTS]
        bias = torch.where(valid.index_select(0, part), 0.0, MASK_DIST)
        if metric == "l2":
            c = codes.index_select(0, part).float()
            sc = scales.index_select(0, part).float()
            r2 = torch.sum(c ** 2, dim=-1)
            if centroids is not None:
                cents = centroids.index_select(0, part).float()
                # quakecheck: disable=QK103(dequantized f32 operands: the centroid term, no int8 accumulation)
                cr = torch.einsum("pd,psd->ps", cents, c)
                x2 = (torch.sum(cents ** 2, dim=-1)[:, None]
                      + 2.0 * sc * cr + sc ** 2 * r2)
            else:
                x2 = sc ** 2 * r2
            bias = x2 + bias
        aux.index_copy_(0, part, bias)
    if centroids is not None:
        qc = queries.float() @ centroids.index_select(0, sel).float().T
    else:
        qc = torch.zeros((queries.shape[0], sel.shape[0]),
                         dtype=torch.float32, device=codes.device)
    return q_codes, q_scales, aux, qc


def scan_indexed_q8_ref(q_codes: Tensor, q_scales: Tensor, codes: Tensor,
                        scales: Tensor, aux: Tensor, qc: Tensor,
                        valid: Tensor, sel: Tensor, qmask: Tensor, k: int,
                        metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Oracle of the int8 scan kernel's function: for query b and union
    slot u over the rows of partition p = sel[u],

        qx   = qc[b, u] + (q_i8[b] . x_i8[p, s]) * q_scale[b] * scale[p, s]
        dist = aux[p, s] + coef * qx       (coef -2 for L2, -1 for IP)

    dequantized in that order; ascending top-k with flat indices
    p * S + s, equal distances keeping the earlier union position, misses
    MASK_DIST / -1.  ``||q||^2`` is left out.  The int8 product is exact
    and then rounded once to f32, as the kernel's int32 sum is: below
    d = 1,041 it runs as an f32 product (every partial sum is an integer
    of magnitude at most 127^2 * d < 2^24, exact in any order), past it
    as an f64 one (exact below 2^53)."""
    d = codes.shape[2]
    exact = torch.float32 if 127 * 127 * d < 1 << 24 else torch.float64
    sel = sel.long()
    coef = -2.0 if metric == "l2" else -1.0
    blocks = codes.index_select(0, sel).to(exact)          # (U, S, d)
    xs = scales.index_select(0, sel).float()                # (U, S)
    aux_u = aux.index_select(0, sel)
    ok = valid.index_select(0, sel)
    qf, qs = q_codes.to(exact), q_scales.float()
    s = codes.shape[1]
    flat_idx = (sel[:, None] * s
                + torch.arange(s, device=sel.device)[None, :]).reshape(-1)
    k_eff = min(k, flat_idx.numel())
    rows = max(1, BLOCK_ELEMS // max(1, flat_idx.numel()))
    out_d = [torch.full((0, k_eff), MASK_DIST, device=codes.device)]
    out_i = [torch.full((0, k_eff), -1, dtype=torch.int32,
                        device=codes.device)]
    for b0 in range(0, q_codes.shape[0], rows):
        # quakecheck: disable=QK103(float operands: int8 sums exact in f32 below 2^24, in f64 past it)
        acc = torch.einsum("usd,bd->bus", blocks, qf[b0:b0 + rows]).float()
        qx = (qc[b0:b0 + rows, :, None]
              + acc * qs[b0:b0 + rows, None, None] * xs[None])
        dist = aux_u[None] + coef * qx
        keep = ok[None] & qmask[b0:b0 + rows, :, None]
        dist = torch.where(keep, dist, torch.full_like(dist, MASK_DIST))
        d_blk, pos = _topk_smallest(dist.reshape(dist.shape[0], -1), k_eff)
        i_blk = torch.where(d_blk >= MASK_DIST, -1, flat_idx[pos])
        out_d.append(d_blk)
        out_i.append(i_blk.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_i)


def scan_selected_q8_ref(queries: Tensor, codes: Tensor, scales: Tensor,
                         valid: Tensor, sel: Tensor, qmask: Tensor, k: int,
                         metric: str = "l2",
                         centroids: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor]:
    """Oracle of the whole int8 scan (the JAX package's
    ``ops.scan_selected_topk_q8``): quantize the queries, form ``aux`` and
    ``qc``, scan, then add ``||q||^2`` (L2, clamped at 0).  ``centroids``
    marks the codes as IVF residuals."""
    operands = q8_scan_operands(queries, codes, scales, valid, sel, metric,
                                centroids)
    d, i = scan_indexed_q8_ref(*operands[:2], codes, scales, *operands[2:],
                               valid, sel, qmask, k, metric)
    if metric == "l2":
        q2 = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
        d = torch.where(d >= MASK_DIST, d, torch.clamp(d + q2, min=0.0))
    return d, torch.where(d >= MASK_DIST, -1, i).to(torch.int32)


def pad_topk(d: Tensor, i: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Pad top-k lists of fewer than ``k`` columns with misses."""
    short = k - d.shape[1]
    if short <= 0:
        return d, i
    d = torch.cat([d, d.new_full((d.shape[0], short), MASK_DIST)], dim=1)
    i = torch.cat([i, i.new_full((i.shape[0], short), -1)], dim=1)
    return d, i


def merge_topk(dists_a: Tensor, idx_a: Tensor, dists_b: Tensor,
               idx_b: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Merge two top-k candidate sets per query row -> ascending top-k."""
    d = torch.cat([dists_a, dists_b], dim=-1)
    i = torch.cat([idx_a, idx_b], dim=-1)
    vals, pos = _topk_smallest(d, k)
    return vals, torch.gather(i, -1, pos)
