"""quake-ann: the paper's own serving configuration as an architecture of
the registry (the reference's ``configs/quake_arch.py``).

An MSTURING100M-scale snapshot (16,384 partitions x 12,288 slots, d=128)
split over the data axes, with four shape cells:

  * serve_fixed_1k    — 1024 queries, static nprobe
  * serve_adaptive_1k — 1024 queries, APS rounds (the paper's method)
  * bulk_brute_8k     — 8192 queries, exact multi-query scan
  * maint_assign_1m   — maintenance's hot op: route 1M inserted vectors
                        to their nearest centroids (the ``kmeans_assign``
                        kernel)

The engine cells run ``ShardedQuakeEngine.mapped_fn`` on the rank's
queries (over the model axis) and its block of partitions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..core.distributed import EngineConfig, ShardedQuakeEngine
from ..core.snapshot import IndexSnapshot
from ..kernels import ops
from ..launch.mesh import P
from .base import Arg, ArchSpec, Cell, dp_axes_for, register

FULL = dict(p=16384, s_cap=12288, d=128, k=100)
SMOKE = dict(p=64, s_cap=64, d=32, k=10)

QUAKE_SHAPES = {
    "serve_fixed_1k": dict(kind="fixed", batch=1024, nprobe=64),
    "serve_adaptive_1k": dict(kind="adaptive", batch=1024),
    "bulk_brute_8k": dict(kind="brute", batch=8192),
    "maint_assign_1m": dict(kind="assign", n=1_000_000),
}
QUAKE_SMOKE_SHAPES = {
    "serve_fixed_1k": dict(kind="fixed", batch=16, nprobe=4),
    "serve_adaptive_1k": dict(kind="adaptive", batch=16),
    "bulk_brute_8k": dict(kind="brute", batch=32),
    "maint_assign_1m": dict(kind="assign", n=4096),
}
STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _ids(shape, dtype, device, gen):
    """Each local slot's external id (a rank's ids need not be its global
    ones: only their shape and validity matter to the search)."""
    return torch.arange(int(np.prod(shape)), dtype=dtype,
                        device=device).reshape(shape)


def _beta(d: int):
    def draw(shape, dtype, device, gen):
        return torch.as_tensor(geometry.betainc_table(d), dtype=dtype,
                               device=device)
    return draw


def snapshot_args(dims, n_shards: int, spec: IndexSnapshot,
                  storage: str = "f32") -> IndexSnapshot:
    """The snapshot's ``Arg``s: partitions padded to split over
    ``n_shards``, every slot full, laid out by ``spec``."""
    p = -(-dims["p"] // n_shards) * n_shards
    s, d = dims["s_cap"], dims["d"]
    data_init = ("randint", -127, 128) if storage == "int8" \
        else ("normal", 1.0)
    return IndexSnapshot(
        data=Arg((p, s, d), STORAGE[storage], spec.data, data_init),
        ids=Arg((p, s), torch.int32, spec.ids, ("call", _ids)),
        centroids=Arg((p, d), torch.float32, spec.centroids,
                      ("normal", 3.0)),
        sizes=Arg((p,), torch.int32, spec.sizes, ("randint", s, s + 1)),
        beta_table=Arg((1024,), torch.float32, spec.beta_table,
                       ("call", _beta(d))),
        scales=(Arg((p, s), torch.float32, spec.scales, ("normal", 0.01))
                if storage == "int8" else None))


def build_quake(shape: str, mesh, smoke: bool = False,
                engine_overrides: dict = None) -> Cell:
    dims = SMOKE if smoke else FULL
    sh = (QUAKE_SMOKE_SHAPES if smoke else QUAKE_SHAPES)[shape]
    dp = dp_axes_for(mesh)

    if sh["kind"] == "assign":
        # maintenance routing: points over the data axes, centroids
        # replicated; the nearest-centroid kernel on the card
        pts = Arg((sh["n"], dims["d"]), torch.float32, P(dp, None),
                  ("normal", 1.0))
        cents = Arg((dims["p"], dims["d"]), torch.float32, P(),
                    ("normal", 3.0))
        return Cell(fn=lambda x, c: ops.kmeans_assign(x, c),
                    args=(pts, cents), mesh=mesh,
                    out_specs=(P(dp), P(dp)), config=dict(dims),
                    description=f"quake maintenance assign n={sh['n']}")

    cfg = EngineConfig(metric="l2", k=dims["k"],
                       nprobe=sh.get("nprobe", 16), part_axes=dp,
                       batch_axis="model", **(engine_overrides or {}))
    eng = ShardedQuakeEngine(mesh, cfg)
    snap = snapshot_args(dims, eng.n_part_shards, eng.snapshot_spec(),
                         cfg.storage_dtype)
    b = sh["batch"]
    q = Arg((b, dims["d"]), torch.float32, eng.query_spec(), ("normal", 3.0))
    qs = eng.query_spec()
    n_out = 4 if sh["kind"] == "adaptive" else 2
    return Cell(fn=eng.mapped_fn(sh["kind"]), args=(q, snap), mesh=mesh,
                out_specs=(qs,) * n_out, config=cfg,
                description=f"quake {sh['kind']} B={b} "
                            f"P={snap.data.shape[0]}")


register(ArchSpec(
    name="quake-ann", family="ann",
    source="Quake (this paper)", shapes=tuple(QUAKE_SHAPES),
    model_config=lambda: dict(FULL),
    smoke_config=lambda: dict(SMOKE),
    build=build_quake,
    notes="the paper's own serving engine on the production mesh"))
