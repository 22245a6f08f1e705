"""k-means for partition construction, split and refinement, and
nearest-centroid assignment.

Lloyd iterations run on the index's device as a plain loop: one
``torch.matmul`` distance matrix per step (the JAX package leaves the same
GEMM to XLA) and a one-hot ``torch.matmul`` over fixed chunks of points for
the cluster sums, so every run adds in the same order and a seed gives
the same centroids, as the JAX package's ``segment_sum`` does
(``index_add_`` on the card adds with atomics in no fixed order).  Empty
clusters are reseeded to the points currently farthest from their
centroid, keeping all k clusters alive.  Seeding stays numpy with the
same generator calls as the JAX package, so both draw the same initial
centroids.  Every entry point takes the caller's ``device`` (the
index's); like ``QuakeIndex`` it defaults to the card and raises without
CUDA.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ref import pairwise_l2_sq
from .device import resolve_device

Tensor = torch.Tensor

_ONEHOT_ELEMS = 1 << 24      # entries of one (k, chunk) one-hot block


def _cluster_sums(xs: Tensor, assign: Tensor, k: int) -> Tensor:
    """(k, d) sums of the points of each cluster, in a fixed order: one
    one-hot product per chunk of points, the chunks added in turn."""
    n = xs.shape[0]
    chunk = max(1, _ONEHOT_ELEMS // k)
    ids = torch.arange(k, device=xs.device)[:, None]
    sums = torch.zeros((k, xs.shape[1]), dtype=xs.dtype, device=xs.device)
    for s in range(0, n, chunk):
        onehot = (assign[None, s:s + chunk] == ids).to(xs.dtype)
        sums += onehot @ xs[s:s + chunk]
    return sums


def _lloyd(xs: Tensor, init_c: Tensor, k: int, iters: int
           ) -> Tuple[Tensor, Tensor]:
    """Lloyd iterations.  xs (N, d) points, init_c (k, d).  Returns
    (centroids, assign (N,) int32); ties go to the smaller centroid."""
    c = init_c
    for _ in range(iters):
        d = pairwise_l2_sq(xs, c)                              # (N, k)
        assign = torch.argmin(d, dim=1)
        mind = torch.gather(d, 1, assign[:, None])[:, 0]
        sums = _cluster_sums(xs, assign, k)
        cnts = torch.bincount(assign, minlength=k).to(xs.dtype)
        new_c = torch.where(cnts[:, None] > 0,
                            sums / torch.clamp(cnts[:, None], min=1.0), c)
        # reseed empties to the currently worst-fit points
        worst = torch.argsort(-mind, stable=True)[:k]
        c = torch.where((cnts == 0)[:, None], xs[worst], new_c)
    assign = torch.argmin(pairwise_l2_sq(xs, c), dim=1).to(torch.int32)
    return c, assign


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           init: str = "random", device="cuda"
           ) -> Tuple[np.ndarray, np.ndarray]:
    """x (n, d) numpy -> (centroids (k, d), assignments (n,)) as numpy,
    with the Lloyd steps on ``device``.  ``init`` seeds the centroids
    with k distinct points drawn at random ("random") or by D^2 sampling
    ("pp", k-means++)."""
    if init not in ("random", "pp"):
        raise ValueError(f"unknown init {init!r}")
    device = resolve_device(device)
    n, d = x.shape
    k = min(k, n)
    rng = np.random.default_rng(seed)
    if init == "pp":
        init_c = _kmeanspp_init(x, k, rng)
    else:
        init_c = x[rng.choice(n, size=k, replace=False)].astype(np.float32)
    xs = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                         device=device)
    c, assign = _lloyd(xs, torch.as_tensor(init_c, device=device), k, iters)
    return c.cpu().numpy(), assign.cpu().numpy()


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator
                   ) -> np.ndarray:
    """D^2-sampling seeding, a host loop as in the JAX package (the same
    generator calls in the same order, so the same seeds)."""
    n = x.shape[0]
    centroids = [x[rng.integers(n)]]
    d2 = np.sum((x - centroids[0]) ** 2, axis=1)
    for _ in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        idx = rng.choice(n, p=probs)
        centroids.append(x[idx])
        d2 = np.minimum(d2, np.sum((x - centroids[-1]) ** 2, axis=1))
    return np.stack(centroids).astype(np.float32)


_ASSIGN_HOST_MAX = 1 << 22   # n*p at or below this: host GEMM off the card


def assign(x: np.ndarray, centroids: np.ndarray, impl: str = "auto",
           device="cuda") -> np.ndarray:
    """Nearest-centroid assignment of host points.

    On a CUDA ``device`` it always runs the assignment kernel.  Elsewhere
    small problems (maintenance-sized, n*p <= 2^22) take a host GEMM, as
    in the JAX package off the TPU, and larger ones the kernel path's
    plain version."""
    dev = resolve_device(device)
    if (impl == "auto" and dev.type != "cuda"
            and x.shape[0] * centroids.shape[0] <= _ASSIGN_HOST_MAX):
        xs = np.asarray(x, dtype=np.float32)
        c = np.asarray(centroids, dtype=np.float32)
        d = np.sum(c * c, axis=1)[None, :] - 2.0 * (xs @ c.T)
        return np.argmin(d, axis=1).astype(np.int32)
    a, _ = ops.kmeans_assign(
        torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev),
        torch.as_tensor(np.asarray(centroids, dtype=np.float32), device=dev),
        impl=impl)
    return a.cpu().numpy()


def split_two(x: np.ndarray, iters: int = 8, seed: int = 0, device="cuda"
              ) -> Tuple[np.ndarray, np.ndarray]:
    """2-means split of one partition (paper §4.2.1 Split) on ``device``:
    (2 centroids, assignment in {0, 1}).  If 2-means puts every point on
    one side, the split falls back to the median along the principal axis
    (host numpy, as in the JAX package), so it is always well defined."""
    if x.shape[0] < 2:
        raise ValueError("cannot split a partition with < 2 vectors")
    c, a = kmeans(x, 2, iters=iters, seed=seed, device=device)
    if (a == 0).all() or (a == 1).all():
        center = x.mean(0)
        xc = x - center
        v = np.ones(x.shape[1], dtype=np.float64)
        for _ in range(8):               # power iteration
            v = xc.T @ (xc @ v)
            v /= max(np.linalg.norm(v), 1e-12)
        proj = xc @ v
        a = (proj > np.median(proj)).astype(np.int32)
        if (a == 0).all() or (a == 1).all():   # all projections equal
            a = (np.arange(x.shape[0]) % 2).astype(np.int32)
        c = np.stack([x[a == 0].mean(0),
                      x[a == 1].mean(0)]).astype(np.float32)
    return c, a


def refine(parts: list, centroids: np.ndarray, iters: int = 1,
           device="cuda") -> Tuple[np.ndarray, list]:
    """Partition refinement (paper §4.2.1): Lloyd steps on ``device``
    seeded by the current centroids over the union of the partitions'
    vectors, then reassignment.  ``parts`` is a list of (vectors (s_j, d),
    ids (s_j,)) aligned with the rows of ``centroids``.  Returns
    (new_centroids, new_parts); a partition left empty keeps its old
    centroid."""
    device = resolve_device(device)
    xs = np.concatenate([p[0] for p in parts], axis=0)
    ids = np.concatenate([p[1] for p in parts], axis=0)
    k = centroids.shape[0]
    c, a = _lloyd(
        torch.as_tensor(np.ascontiguousarray(xs, dtype=np.float32),
                        device=device),
        torch.as_tensor(np.asarray(centroids, dtype=np.float32),
                        device=device), k, iters)
    c, a = c.cpu().numpy(), a.cpu().numpy()
    new_parts = []
    for j in range(k):
        sel = a == j
        new_parts.append((xs[sel], ids[sel]))
        if not sel.any():
            c[j] = centroids[j]
    return c, new_parts
