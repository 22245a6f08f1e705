"""Candidate retrieval through the Quake index (the paper's use case).

    PYTHONPATH=src python -m repro_torch.examples.retrieval_serving \
        [--device cpu]

End-to-end recsys retrieval path (the JAX package's
``examples/retrieval_serving.py``, on the card unless ``--device cpu``):
  1. a two-tower model (the arch ``two-tower-retrieval``, scaled down)
     encodes users and a 60k-item corpus into a shared inner-product
     space (unit-norm embeddings),
  2. the item embeddings are indexed by Quake (MIPS metric),
  3. user queries are served three ways and compared:
       brute     exact batched GEMM over all items (the retrieval_cand
                 path)
       quake     QuakeIndex with per-query APS at a 0.9 recall target
       engine    ShardedQuakeEngine on a one-rank mesh (padded
                 partitions, APS rounds; then fixed-nprobe int8 codes
                 through the q8 scan kernel).
The engine's mesh is ``launch.mesh.make_host_mesh`` over a one-rank
process group (NCCL on the card, gloo on the CPU) made for the call,
unless one is already initialized.
"""
from __future__ import annotations

import argparse
import contextlib
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import (EngineConfig, IndexSnapshot, QuakeConfig, QuakeIndex,
                    ShardedQuakeEngine, resolve_device)
from ..launch.mesh import make_host_mesh
from ..models import recsys


@contextlib.contextmanager
def one_rank_group(dev: torch.device):
    """A one-rank process group for the call, unless one exists."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="retrieval_pg_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/init", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _recall(ids, gt, k: int) -> float:
    return float(np.mean([len(set(np.asarray(ids[r]).tolist())
                              & set(gt[r].tolist())) / k
                          for r in range(len(gt))]))


def run(user_vocab: int = 20_000, item_vocab: int = 60_000,
        embed_dim: int = 32, tower_mlp=(64, 32), hist_len: int = 16,
        batch: int = 256, k: int = 10, device="cuda",
        model: recsys.TwoTower = None, history: np.ndarray = None) -> dict:
    """The example's steps at its sizes (the reference's by default).
    ``model`` (weights drawn from seed 0 on ``device`` by default) and
    ``history`` (B, hist_len) user ids (drawn from seed 0) can be given.
    Returns the printed numbers."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cfg = recsys.TwoTowerConfig(user_vocab=user_vocab, item_vocab=item_vocab,
                                embed_dim=embed_dim,
                                tower_mlp=tuple(tower_mlp),
                                hist_len=hist_len)
    if model is None:
        model = recsys.TwoTower(
            cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    out = {}

    # --- encode the item corpus (what a nightly batch job would do) -------
    with torch.no_grad():
        items = recsys.item_repr(
            model, torch.arange(cfg.item_vocab, device=dev)).cpu().numpy()
    out["items"], out["dim"] = items.shape
    print(f"encoded {items.shape[0]} items, dim={items.shape[1]}")

    # --- encode a user query batch ----------------------------------------
    if history is None:
        history = rng.integers(0, cfg.user_vocab, (batch, cfg.hist_len))
    b = len(history)
    hb = {"history": torch.as_tensor(history, device=dev),
          "history_mask": torch.ones((b, cfg.hist_len), dtype=torch.bool,
                                     device=dev)}
    with torch.no_grad():
        users = recsys.user_repr(model, hb).cpu().numpy()

    # --- exact baseline: one GEMM (the retrieval_cand dry-run cell) -------
    t0 = time.perf_counter()
    scores = users @ items.T
    gt = np.argsort(-scores, axis=1)[:, :k]
    out["brute_us"] = (time.perf_counter() - t0) / b * 1e6

    # --- Quake index with per-query APS -----------------------------------
    idx = QuakeIndex.build(items, config=QuakeConfig(metric="ip"),
                           device=dev)
    t0 = time.perf_counter()
    recs, scanned = [], []
    for i in range(b):
        r = idx.search(users[i], k, recall_target=0.9)
        recs.append(len(set(r.ids.tolist()) & set(gt[i].tolist())) / k)
        scanned.append(r.vectors_scanned)
    out["quake_us"] = (time.perf_counter() - t0) / b * 1e6
    out["quake_recall"] = float(np.mean(recs))
    out["quake_scanned"] = float(np.mean(scanned))
    print(f"\nbrute : {out['brute_us']:7.0f} us/query  recall=1.000  "
          f"scanned={items.shape[0]}")
    print(f"quake : {out['quake_us']:7.0f} us/query  "
          f"recall={out['quake_recall']:.3f}  "
          f"scanned={out['quake_scanned']:.0f}  "
          f"({items.shape[0] / out['quake_scanned']:.0f}x fewer)")

    # --- the sharded engine on a one-rank mesh ----------------------------
    with one_rank_group(dev):
        mesh = make_host_mesh(device=dev)
        eng = ShardedQuakeEngine(mesh, EngineConfig(
            k=k, nprobe=16, recall_target=0.9, part_axes=("data",)))
        snap = eng.shard_snapshot(IndexSnapshot.from_index(idx))
        qs = eng.pad_queries(torch.as_tensor(users))
        eng.search_adaptive(qs, snap)                       # warm
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_e, i_e, r_est, nprobe = eng.search_adaptive(qs, snap)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["engine_us"] = (time.perf_counter() - t0) / b * 1e6
        out["engine_recall"] = _recall(i_e.cpu().numpy(), gt, k)
        out["engine_nprobe"] = float(nprobe.float().mean())
        print(f"engine: {out['engine_us']:7.0f} us/query  "
              f"recall={out['engine_recall']:.3f}  (batched, APS rounds, "
              f"mean nprobe={out['engine_nprobe']:.1f})")

        # --- int8 residual-quantized engine (paper §8.2; 4x less scan
        # traffic) ---------------------------------------------------------
        eng8 = ShardedQuakeEngine(mesh, EngineConfig(
            k=k, nprobe=24, part_axes=("data",), scan_impl="union_cuda",
            storage_dtype="int8"))
        ss8 = eng8.shard_snapshot(IndexSnapshot.from_index(idx))
        d_8, i_8 = eng8.search_fixed(qs, ss8)
        out["int8_recall"] = _recall(i_8.cpu().numpy(), gt, k)
        print(f"int8  :      —  us/query  recall={out['int8_recall']:.3f}  "
              f"(IVF-residual SQ8 codes, 4x less scan traffic)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
