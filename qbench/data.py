"""Seeded vector data made on the device: a frozen copy of the cluster
mixture that the repository's main path draws (``chip_smoke.py`` path 1,
``datasets.clustered``): centres N(0, center_scale^2 I), cluster sizes
proportional to i^-power, a spread per cluster uniform in
[spread_lo, spread_hi).  Drawn with ``torch.Generator``s on the device in
a few large calls.

A configuration's base table is fixed, as SIFT1M's base set is: its mixture and rows come from the configuration's ``mixture_seed``
and ``data_seed``.  What a run sends (its queries) comes from the run's
``--seed``.  The same rows in another order build
another index, and the APS plans of two such builds differ up to tenfold
in probes, so a seed that redrew the table would change the work."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Mixture:
    centers: torch.Tensor     # (C, d) f32
    scale: torch.Tensor       # (C,) f32
    weights: torch.Tensor     # (C,) f64, sums to 1


def generator(seed: int, dev: torch.device, stream: int) -> torch.Generator:
    """A generator on ``dev`` for one named stream of a run's draws."""
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def mixture(dim: int, clusters: int, power: float, center_scale: float,
            spread_lo: float, spread_hi: float, g: torch.Generator,
            dev: torch.device) -> Mixture:
    centers = torch.randn((clusters, dim), generator=g, device=dev) \
        * center_scale
    w = 1.0 / torch.arange(1, clusters + 1, device=dev,
                           dtype=torch.float64) ** power
    scale = spread_lo + (spread_hi - spread_lo) * torch.rand(
        (clusters,), generator=g, device=dev)
    return Mixture(centers, scale, w / w.sum())


def draw(mix: Mixture, n: int, g: torch.Generator):
    """(rows (n, d) f32, cluster ids (n,) int64) from ``mix``, clusters
    chosen by the mixture's sizes."""
    cid = torch.multinomial(mix.weights, n, replacement=True, generator=g)
    x = torch.randn((n, mix.centers.shape[1]), generator=g,
                    device=mix.centers.device)
    x.mul_(mix.scale[cid, None]).add_(mix.centers[cid])
    return x, cid


def base_rows(cfg: dict, mix: Mixture, dev: torch.device):
    """The configuration's fixed base table: (rows, cluster ids)."""
    return draw(mix, int(cfg["rows"]),
                generator(int(cfg["data"]["data_seed"]), dev, 1))


def from_config(cfg: dict, dev: torch.device) -> Mixture:
    """The configuration's mixture: its centres and spreads are drawn from
    the configuration's own ``mixture_seed``."""
    d = cfg["data"]
    g = generator(int(d["mixture_seed"]), dev, 0)
    return mixture(cfg["dim"], d["clusters"], d["power"], d["center_scale"],
                   d["spread_lo"], d["spread_hi"], g, dev)
