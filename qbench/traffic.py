"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and turns them into the run's work, the same for every seed but for the
draws.

The ``batch`` loop: a closed loop of ``batch``-query batches, each query
a row of the data drawn uniformly plus N(0, jitter^2 I) (the main path's
``queries_near``).  The run draws ``pool_batches`` batches in set-up and
sends them in turn, so every batch of a window holds fresh queries until
the pool is spent (only a window that runs past it sends a batch again).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import data as qdata


@dataclass
class BatchWork:
    pool: np.ndarray           # (pool_batches, B, d) f32 host
    warm: int                  # batches run in set-up


def batch_work(traffic: dict, cfg: dict, x: torch.Tensor, seed: int
               ) -> BatchWork:
    b, nb = int(traffic["batch"]), int(traffic["pool_batches"])
    g = qdata.generator(seed, x.device, 3)
    rows = torch.randint(0, x.shape[0], (nb * b,), generator=g,
                         device=x.device)
    jitter = float(cfg["data"].get("query_jitter",
                                   traffic.get("query_jitter", 0.1)))
    q = x[rows] + jitter * torch.randn((nb * b, x.shape[1]), generator=g,
                                       device=x.device)
    return BatchWork(pool=q.reshape(nb, b, -1).cpu().numpy(),
                     warm=int(traffic.get("warm_batches", 2)))
