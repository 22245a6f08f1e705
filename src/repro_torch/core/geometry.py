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

The functions take torch tensors; ``betainc_table`` and
``exact_beta_fn`` are host numpy, as the index keeps them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

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


def exact_beta_fn(dim: int):
    """Exact (untabulated) I_x((dim+1)/2, 1/2) for the APS-RP ablation
    (paper Table 2): a host callable taking x as f32 and returning f64,
    as the JAX package's does (which evaluates in f32: the value is
    rounded to f32 here too).  Set it as an index's ``_beta_table``; one
    evaluation per recall recompute is the cost of skipping the table."""
    a = (dim + 1) / 2.0

    def beta(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32).astype(np.float64)
        return scipy.special.betainc(a, 0.5, x).astype(np.float32) \
            .astype(np.float64)

    return beta


def cap_fraction_exact(h_over_rho: Tensor, dim: int) -> Tensor:
    """Exact cap volume fraction; ``h_over_rho`` in [-1, 1], clipped
    outside.  I_x is evaluated on the host (scipy, f64) and returned on
    the input's device in its dtype."""
    t = torch.clamp(h_over_rho, -1.0, 1.0)
    x = torch.clamp(1.0 - t * t, 0.0, 1.0)
    val = scipy.special.betainc((dim + 1) / 2.0, 0.5,
                                x.detach().cpu().double().numpy())
    half = 0.5 * torch.as_tensor(val, device=x.device).to(x.dtype)
    return torch.where(t >= 0, half, 1.0 - half)


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


@dataclass(frozen=True)
class MipsGeometry:
    """Augmentation constant M^2 of the inner-product metric (see the
    module's docstring)."""
    max_norm_sq: float

    def rho_sq(self, q_norm_sq, kth_score):
        """Squared radius in the augmented space of the k-th best inner
        product ``kth_score``: max(||q||^2 + M^2 - 2 s_k, 0).  Tensors or
        numpy arrays."""
        r = q_norm_sq + self.max_norm_sq - 2.0 * kth_score
        if isinstance(r, Tensor):
            return torch.clamp(r, min=0.0)
        return np.maximum(r, 0.0)


def augment_for_mips(x: np.ndarray, max_norm_sq: float | None = None
                     ) -> tuple[np.ndarray, float]:
    """Append the column sqrt(M^2 - ||x||^2) (f64 norms); returns
    (augmented in x's dtype, M^2), M^2 the largest squared norm unless
    given."""
    n2 = np.sum(x.astype(np.float64) ** 2, axis=-1)
    if max_norm_sq is None:
        max_norm_sq = float(np.max(n2)) if len(n2) else 1.0
    extra = np.sqrt(np.maximum(max_norm_sq - n2, 0.0))
    return (np.concatenate([x, extra[:, None]], axis=-1).astype(x.dtype),
            max_norm_sq)
