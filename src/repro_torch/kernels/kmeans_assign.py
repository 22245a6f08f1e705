"""Nearest-centroid assignment: insert routing and maintenance.

Replaces the JAX package's ``kmeans_assign_pallas``.  For each point, the
argmin over centroids of ``aux[c] - 2 x.c`` with ``aux = ||c||^2`` plus
MASK_DIST on invalid centroids; ties go to the smallest centroid index.
Returns (assignment (N,) int32, minimum (N,) f32) without ``||x||^2``,
which the caller adds; a point with no centroid below MASK_DIST gets -1.

``kmeans_assign`` launches the CUDA kernel (``csrc/kmeans_assign.cu``)
for CUDA tensors and runs the plain version beside it for CPU tensors.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import build
from .ref import MASK_DIST

Tensor = torch.Tensor

LAUNCHES = build.LaunchCounter("kmeans_assign")
TILE = 128           # points, and centroids, per block tile (csrc TILE)
BLOCKS_PER_SM = 4    # blocks in flight an SM that the centroid split aims at


def kmeans_assign_plain(xs: Tensor, centroids: Tensor, aux: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (f32)."""
    dist = aux[None, :].float() - 2.0 * (xs.float() @ centroids.float().T)
    assign = torch.argmin(dist, dim=1)      # first index on ties
    mind = torch.gather(dist, 1, assign[:, None])[:, 0]
    hit = mind < MASK_DIST
    assign = torch.where(hit, assign, -1).to(torch.int32)
    mind = torch.where(hit, mind, torch.full_like(mind, MASK_DIST))
    return assign, mind


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tiles_per_split(n: int, c: int, dev: torch.device) -> Tuple[int, int]:
    """(centroid tiles a block takes, splits): enough splits of the
    centroid tiles that some BLOCKS_PER_SM blocks an SM are in flight."""
    point_tiles, tiles = -(-n // TILE), -(-c // TILE)
    want = -(-BLOCKS_PER_SM * _sm_count(dev) // point_tiles)
    per = max(1, tiles // want)
    return per, -(-tiles // per)


def kmeans_assign_cuda(xs: Tensor, centroids: Tensor, aux: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """Launch the CUDA kernel.  Raises on any operand it does not take."""
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError("kmeans_assign_cuda needs CUDA tensors")
    for name, t in (("xs", xs), ("centroids", centroids), ("aux", aux)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xs on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, d = xs.shape
    c = centroids.shape[0]
    if centroids.shape != (c, d) or aux.shape != (c,):
        raise ValueError(f"shapes disagree: xs {tuple(xs.shape)}, "
                         f"centroids {tuple(centroids.shape)}, aux "
                         f"{tuple(aux.shape)}")
    if n == 0 or c == 0:
        return (torch.full((n,), -1, dtype=torch.int32, device=dev),
                torch.full((n,), MASK_DIST, dtype=torch.float32, device=dev))
    out_a = torch.empty((n,), dtype=torch.int32, device=dev)
    out_d = torch.empty((n,), dtype=torch.float32, device=dev)
    per, splits = _tiles_per_split(n, c, dev)
    part_a = part_d = 0
    if splits > 1:   # each split's (argmin, min), merged by a second kernel
        # one buffer: part[1] holds the minima's f32 bits
        part = torch.empty((2, splits, n), dtype=torch.int32, device=dev)
        part_a, part_d = part[0].data_ptr(), part[1].data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("kmeans_assign").kmeans_assign(
        xs.data_ptr(), centroids.data_ptr(), aux.data_ptr(),
        out_a.data_ptr(), out_d.data_ptr(), part_a, part_d, n, c, d, per,
        stream)
    build.check_launch(err, "kmeans_assign")
    LAUNCHES.add()
    return out_a, out_d


def kmeans_assign(xs: Tensor, centroids: Tensor, aux: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if xs.is_cuda:
        return kmeans_assign_cuda(xs, centroids, aux)
    if xs.device.type != "cpu":
        raise ValueError(f"unsupported device {xs.device}")
    return kmeans_assign_plain(xs, centroids, aux)
