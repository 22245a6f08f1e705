"""Hyperspherical-cap geometry for APS recall estimation (paper §5).

Given query ``q``, radius ``rho`` (distance to the current k-th nearest
neighbour) and candidate partition centroids, APS approximates each
non-nearest partition as the half-space beyond the perpendicular bisector
between the nearest centroid ``c0`` and that partition's centroid ``ci``.
The fraction of the query ball beyond the bisector is a hyperspherical cap:

    cap_frac(h) = 1/2 * I_{1-(h/rho)^2}((d+1)/2, 1/2)        for 0 <= h <= rho

and ``1 - cap_frac(-h)`` for h < 0.  ``I_x(a, 1/2)`` is precomputed on a
1024-point grid (paper opt. #1) and interpolated per query.

Inner product uses the MIPS -> L2 reduction on the centroid geometry
(x -> [x, sqrt(M^2 - ||x||^2)], q -> [q, 0]), so the same cap machinery
applies with rho^2 = ||q||^2 + M^2 - 2 s_k.

The functions take torch tensors; ``betainc_table`` is host numpy, as
the index keeps it.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.special
import torch

Tensor = torch.Tensor

_TABLE_POINTS = 1024


@functools.lru_cache(maxsize=64)
def betainc_table(dim: int, n_points: int = _TABLE_POINTS) -> np.ndarray:
    """Precomputed I_x((dim+1)/2, 1/2) over x in [0, 1] (paper §5 opt. #1),
    evaluated in f64 and stored as f32."""
    xs = np.linspace(0.0, 1.0, n_points, dtype=np.float64)
    vals = scipy.special.betainc((dim + 1) / 2.0, 0.5, xs)
    return np.asarray(vals, dtype=np.float32)


def cap_fraction(h_over_rho: Tensor, table: Tensor) -> Tensor:
    """Table-interpolated cap fraction."""
    t = torch.clamp(h_over_rho, -1.0, 1.0)
    x = torch.clamp(1.0 - t * t, 0.0, 1.0)
    n = table.shape[0]
    pos = x * (n - 1)
    lo = torch.clamp(torch.floor(pos).long(), 0, n - 2)
    frac = pos - lo.to(pos.dtype)
    val = table[lo] * (1.0 - frac) + table[lo + 1] * frac
    half = 0.5 * val
    return torch.where(t >= 0, half, 1.0 - half)


def bisector_margins(d0_sq: Tensor, di_sq: Tensor, cc_dist: Tensor
                     ) -> Tensor:
    """Distance from the query to the bisector between c0 and each ci:
    (||q-ci||^2 - ||q-c0||^2) / (2 ||ci-c0||)."""
    return (di_sq - d0_sq) / (2.0 * torch.clamp(cc_dist, min=1e-20))


def partition_probabilities(v: Tensor, valid: Tensor
                            ) -> tuple[Tensor, Tensor]:
    """Paper Eqs. (8)-(9): normalize cap volumes over the non-nearest
    candidates, p0 = prod(1 - v_j), remainder split proportionally."""
    v = torch.where(valid, v, torch.zeros_like(v))
    total = torch.sum(v)
    vn = torch.where(total > 0, v / torch.clamp(total, min=1e-20),
                     torch.zeros_like(v))
    log1m = torch.where(valid,
                        torch.log1p(-torch.clamp(vn, 0.0, 1.0 - 1e-7)),
                        torch.zeros_like(v))
    p0 = torch.exp(torch.sum(log1m))
    p0 = torch.where(total > 0, p0, torch.ones_like(p0))
    return p0, (1.0 - p0) * vn
