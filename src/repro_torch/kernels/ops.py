"""Public wrappers around the scan kernels, mirroring the JAX package's
``kernels/ops.py``.

Dispatch policy (``impl``):
  - "torch": the plain oracles of ``ref.py`` (the JAX package's "jnp").
  - "cuda":  the kernel path: the hand-written CUDA kernel for CUDA
             tensors, the kernel's plain version beside it for CPU
             tensors (the JAX package's "pallas", run in interpret mode
             on a CPU).
  - "auto":  "cuda" for CUDA tensors, "torch" for CPU tensors; meta
             tensors take "cuda" inside ``build.card_route_on_meta`` (the
             dry-run counts the card's route) and "torch" outside it.

The wrappers own un-padding and the terms the kernels leave out
(``||q||^2`` / ``||x||^2``), so callers never see kernel constraints.
Unlike the JAX kernel paths (f32 and int8), whose tile can clip
``k_pad`` below ``k``, every path here returns ``k`` columns.

``pack_union``, ``pack_round``, ``pack_round_masked`` and ``topk_merge``
are plain PyTorch on whatever device their inputs live on; the JAX
package computes them outside any Pallas kernel too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build as _build
from . import kmeans_assign as _kmeans_assign_kernel
from . import ref
from . import scan_topk as _scan_topk_kernel
from . import scan_topk_indexed as _scan_indexed_kernel
from .ref import MASK_DIST

Tensor = torch.Tensor

IMPLS = ("torch", "cuda", "auto")


def _resolve(impl: str, t: Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if _build.card_route(t) else "torch"
    return impl


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _add_q2_mark_misses(queries: Tensor, dd: Tensor, ii: Tensor,
                        metric: str) -> Tuple[Tensor, Tensor]:
    """Add back ``||q||^2`` (clamped at 0) and send misses to index -1."""
    if metric == "l2":
        q2 = torch.sum(queries.float() ** 2, dim=-1, keepdim=True)
        dd = torch.where(dd >= MASK_DIST, dd, torch.clamp(dd + q2, min=0.0))
    ii = torch.where(dd >= MASK_DIST, torch.full_like(ii, -1), ii)
    return dd, ii


def scan_topk(queries: Tensor, xs: Tensor, k: int, *, metric: str = "l2",
              valid: Optional[Tensor] = None, impl: str = "auto"
              ) -> Tuple[Tensor, Tensor]:
    """Top-k nearest of each query against ``xs``: (dists (Q, k)
    ascending, idx (Q, k) int32); misses are MASK_DIST with idx -1."""
    impl = _resolve(impl, xs)
    k_eff = min(k, xs.shape[0])
    if impl == "torch":
        d, i = ref.scan_topk_ref(queries, xs, k_eff, metric, valid)
    else:
        dd, ii = _scan_topk_kernel.scan_topk(
            queries.to(xs.dtype).contiguous(), xs.contiguous(), valid,
            k_pad=_next_pow2(max(k_eff, 1)), metric=metric)
        d, i = _add_q2_mark_misses(queries, dd[:, :k_eff], ii[:, :k_eff],
                                   metric)
    return ref.pad_topk(d, i, k)


def pack_union(selected: Tensor, n_union: int,
               priority: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Pack per-query partition selections ``selected`` (B, P) bool into
    one union scan plan: (sel (n_union,) int32, qmask (B, n_union) bool).
    The union is frequency-ranked (descending probe count plus
    ``priority``; equal counts keep the smaller partition id first, as
    ``jax.lax.top_k`` does)."""
    counts = torch.sum(selected, dim=0, dtype=torch.int32)
    if priority is not None:
        counts = counts + priority
    order = torch.sort(counts, descending=True, stable=True).indices
    sel = order[:n_union]
    qmask = selected.index_select(1, sel)
    return sel.to(torch.int32), qmask


def _selected_matrix(sel_q: Tensor, qvalid: Tensor, p: int) -> Tensor:
    """(B, P) bool: query b selects partition sel_q[b, j] where
    qvalid[b, j] (a scatter, so no device sync)."""
    b = sel_q.shape[0]
    rows = torch.arange(b, device=sel_q.device)[:, None]
    flat = (rows * p + sel_q.long()).reshape(-1)
    hits = torch.zeros(b * p, dtype=torch.int32, device=sel_q.device)
    hits.scatter_add_(0, flat, qvalid.reshape(-1).to(torch.int32))
    return (hits > 0).reshape(b, p)


def pack_round(sel_q: Tensor, qvalid: Tensor, priority: Tensor, *, p: int,
               n_union: int) -> Tuple[Tensor, Tensor]:
    """Round-aware masked pack: ``sel_q`` (B, W) probe columns this round,
    ``qvalid`` (B, W) their mask -> ``pack_union``'s (sel, qmask)."""
    return pack_union(_selected_matrix(sel_q, qvalid, p), n_union,
                      priority=priority)


def pack_round_masked(sel_q: Tensor, qvalid: Tensor, priority: Tensor,
                      n_real: int, *, p: int, u_pad: int
                      ) -> Tuple[Tensor, Tensor]:
    """``pack_round`` with the inert tail applied on device: union slots
    at or past ``n_real`` duplicate ``sel[0]`` under an all-False mask,
    and the width is padded to ``u_pad`` the same way."""
    n_dev = min(u_pad, p)
    sel, qmask = pack_round(sel_q, qvalid, priority, p=p, n_union=n_dev)
    return _inert_tail(sel, qmask, n_real, u_pad)


def _inert_tail(sel: Tensor, qmask: Tensor, n_real: int, u_pad: int
                ) -> Tuple[Tensor, Tensor]:
    n_dev = sel.shape[0]
    live = torch.arange(n_dev, device=sel.device) < n_real
    sel = torch.where(live, sel, sel[0])
    qmask = qmask & live[None, :]
    if u_pad > n_dev:
        b = qmask.shape[0]
        sel = torch.cat([sel, sel[:1].expand(u_pad - n_dev)])
        qmask = torch.cat(
            [qmask, qmask.new_zeros((b, u_pad - n_dev))], dim=1)
    return sel, qmask


def topk_merge(dists_a: Tensor, idx_a: Tensor, dists_b: Tensor,
               idx_b: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Merge two per-query top-k candidate lists (ascending; misses
    MASK_DIST / -1) on their device — the round executor's running
    top-k never leaves the device."""
    return ref.merge_topk(dists_a, idx_a, dists_b, idx_b, k)


def scan_selected_topk(queries: Tensor, data: Tensor, valid: Tensor,
                       sel: Tensor, qmask: Tensor, k: int, *,
                       metric: str = "l2", impl: str = "auto"
                       ) -> Tuple[Tensor, Tensor]:
    """Top-k of each query over the union of selected partition blocks.

    queries (B, d); data (P, S, d); valid (P, S) bool; sel (U,) int;
    qmask (B, U) bool.  Returns ascending (dists (B, k), flat idx (B, k)
    = partition * S + slot).  The kernel path reads each selected
    partition once per tile of queries and only its live rows."""
    impl = _resolve(impl, data)
    s = data.shape[1]
    k_eff = min(k, sel.shape[0] * s)
    if impl == "torch":
        d, i = ref.scan_selected_ref(queries, data, valid, sel, qmask,
                                     k_eff, metric)
    else:
        dd, ii = _scan_indexed_kernel.scan_topk_indexed(
            queries.to(data.dtype).contiguous(), data.contiguous(),
            valid.contiguous(), sel.to(torch.int32).contiguous(),
            qmask.contiguous(), k_pad=_next_pow2(max(k_eff, 1)),
            metric=metric)
        d, i = _add_q2_mark_misses(queries, dd[:, :k_eff], ii[:, :k_eff],
                                   metric)
    return ref.pad_topk(d, i, k)


def scan_selected_topk_q8(queries: Tensor, codes: Tensor, scales: Tensor,
                          valid: Tensor, sel: Tensor, qmask: Tensor, k: int,
                          *, metric: str = "l2",
                          centroids: Optional[Tensor] = None,
                          impl: str = "auto") -> Tuple[Tensor, Tensor]:
    """int8 variant of ``scan_selected_topk`` (paper §8.2 compression):
    ``codes`` (P, S, d) int8 with per-slot ``scales`` (P, S).  Queries are
    quantized per row; with ``centroids`` (P, d) the codes are IVF
    residuals (x = c_j + s * codes) and the exact f32 query-centroid term
    is added per selected partition.  Returns ascending (dists (B, k),
    flat idx (B, k)), k columns on every path."""
    impl = _resolve(impl, codes)
    s = codes.shape[1]
    k_eff = min(k, sel.shape[0] * s)
    if impl == "torch":
        d, i = ref.scan_selected_q8_ref(queries, codes, scales, valid, sel,
                                        qmask, k_eff, metric,
                                        centroids=centroids)
    else:
        q_codes, q_scales, aux, qc = ref.q8_scan_operands(
            queries, codes, scales, valid, sel, metric, centroids)
        dd, ii = _scan_indexed_kernel.scan_topk_indexed_q8(
            q_codes, q_scales, codes.contiguous(), scales.float().contiguous(),
            aux, qc.contiguous(), valid.contiguous(),
            sel.to(torch.int32).contiguous(), qmask.contiguous(),
            k_pad=_next_pow2(max(k_eff, 1)), metric=metric)
        d, i = _add_q2_mark_misses(queries, dd[:, :k_eff], ii[:, :k_eff],
                                   metric)
    return ref.pad_topk(d, i, k)


def kmeans_assign(xs: Tensor, centroids: Tensor, *,
                  valid_centroids: Optional[Tensor] = None,
                  impl: str = "auto") -> Tuple[Tensor, Tensor]:
    """Nearest-centroid assignment: (assign (N,) int32, min sq dist (N,))."""
    impl = _resolve(impl, xs)
    if impl == "torch":
        d = ref.pairwise_l2_sq(xs, centroids)
        if valid_centroids is not None:
            d = torch.where(valid_centroids[None, :], d,
                            torch.full_like(d, MASK_DIST))
        a = torch.argmin(d, dim=-1)
        return a.to(torch.int32), torch.gather(d, 1, a[:, None])[:, 0]
    cents = centroids.float().contiguous()
    bias = torch.zeros(cents.shape[0], device=cents.device)
    if valid_centroids is not None:
        bias = torch.where(valid_centroids, bias,
                           torch.full_like(bias, MASK_DIST))
    aux = torch.sum(cents ** 2, dim=-1) + bias
    a, dd = _kmeans_assign_kernel.kmeans_assign(xs.float().contiguous(),
                                                cents, aux)
    x2 = torch.sum(xs.float() ** 2, dim=-1)
    return a, torch.clamp(dd + x2, min=0.0)
