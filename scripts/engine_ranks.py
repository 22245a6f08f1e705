#!/usr/bin/env python3
"""The sharded engine across ranks, held against one rank.

    python scripts/engine_ranks.py --ranks 4                  # 4 cards, NCCL
    PYTHONPATH=src python scripts/engine_ranks.py --device cpu --ranks 4 \
        --n 20000 --batch 64                                   # gloo, CPU

The parent process builds a clustered index (``datasets.clustered``,
``chip_smoke.py``'s main-path data: 8,192 clusters, sizes proportional to
i^-0.5, P = sqrt(n)), saves it (``QuakeIndex.save``) and runs the engine
on a one-device mesh (no process group) as the reference:
``search_bruteforce``, ``search_fixed``, ``search_adaptive`` and
``search_batch`` at ``scan_impl="union_cuda"``, k = ``--k``, nprobe 32,
chunk 2, 16 rounds, target 0.9.  Then it starts ``--ranks`` processes
(NCCL on CUDA, one card each; gloo on the CPU) that load the index and
make the same calls under three layouts of the ranks:

  * "partitions": ("data", "model") = (R, 1), partitions over "data";
    every rank holds 1/R of the partitions and sees every query;
  * "grid": ("pod", "data", "model") = (1, R/2, 2), partitions over
    ("pod", "data"), queries over "model";
  * "replicated": ("data", "model") = (R, 1), no partition axis, queries
    over "data"; every rank holds the whole index.

It fails unless every rank returns the same whole-batch results and
plans the same ``search_batch`` probe matrices; brute force (every
layout) and ``search_batch`` (every layout) equal the reference but at
near-ties of the k-th distance, with ``search_batch``'s rounds and
partitions scanned; and the replicated layout's ``search_fixed`` equals
the reference.  The rest differ from one rank by design (the JAX
engine's semantics), so only their recall is printed: with partitions
split, ``search_fixed`` probes ceil(nprobe / shards) per shard and
``search_adaptive`` scans ``chunk`` a shard a round; with queries split,
each batch shard runs its own adaptive rounds until its own queries meet
the target.  It prints recall@k
and the warm wall time of every call per layout, beside the card's name
and power limit, and writes the record to ``--out``.  On the card every
rank also profiles one more warm ``search_batch`` per layout: its wall
time, the device's busy time (``torch.profiler``) and the host time spent
planning (``plan_rounds`` / ``plan_batch``) and inside the rounds' scans
(``_scan_planned``: the probe matrix's copy, pack, scan launch and
collectives).

The timing, the top-k comparison and the profile are ``chip_smoke.py``'s
(``warm_then_time``, ``compare_topk``, ``profile_call``), so the checks
stay in step; ``record_plans`` / ``plans_agree`` are the plan-agreement
check that ``tests/test_torch_distributed.py``'s gloo ranks use too.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import hashlib
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import (ENGINE_CHUNK, ENGINE_NPROBE, ENGINE_ROUNDS,  # noqa: E402
                        ENGINE_TARGET, card_line, compare_topk,
                        profile_call, recall_at, warm_then_time)

ENTRIES = ("bruteforce", "fixed", "adaptive", "batch")


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--clusters", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "engine_ranks"))
    return ap.parse_args()


@contextlib.contextmanager
def record_plans(plans: list):
    """Within the block, every ``search_batch`` scan of every engine adds
    to ``plans`` an 8-byte digest of the (B, P) probe matrix and anchor it
    scans.  Every rank plans on its own host copy of the index, so the
    digests must agree across ranks (``plans_agree``)."""
    from repro_torch.core import ShardedQuakeEngine
    scan = ShardedQuakeEngine._scan_planned

    def spy(self, qp, snap, selected, anchor, n_union):
        plans.append(hashlib.sha256(
            np.packbits(selected).tobytes()
            + np.packbits(anchor).tobytes()).digest()[:8])
        return scan(self, qp, snap, selected, anchor, n_union)
    ShardedQuakeEngine._scan_planned = spy
    try:
        yield plans
    finally:
        ShardedQuakeEngine._scan_planned = scan


def plans_agree(plans: list, device) -> np.ndarray:
    """All-gather every rank's plan digests over the default process
    group; raise unless they are the same on every rank.  Returns them."""
    import torch
    import torch.distributed as dist
    h = torch.tensor(np.frombuffer(b"".join(plans), dtype=np.int64),
                     device=device)
    every = [torch.empty_like(h) for _ in range(dist.get_world_size())]
    dist.all_gather(every, h)
    if not all(torch.equal(e, h) for e in every):
        raise SystemExit(f"rank {dist.get_rank()}: the ranks' plans differ")
    return h.cpu().numpy()


@contextlib.contextmanager
def host_timers(ms: dict):
    """Within the block, the host time of the engine's planning
    (``plan_rounds`` / ``plan_batch``) and of its planned scans
    (``_scan_planned``) accumulates in ``ms`` (milliseconds)."""
    from repro_torch.core import distributed as dmod

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return run
    swaps = [(dmod, "plan_rounds", "plan"), (dmod, "plan_batch", "plan"),
             (dmod.ShardedQuakeEngine, "_scan_planned", "scan")]
    old = [getattr(obj, attr) for obj, attr, _ in swaps]
    for (obj, attr, name), fn in zip(swaps, old):
        setattr(obj, attr, timed(name, fn))
    try:
        yield ms
    finally:
        for (obj, attr, _), fn in zip(swaps, old):
            setattr(obj, attr, fn)


def layouts(ranks: int) -> dict:
    return {"partitions": ((ranks, 1), ("data", "model"),
                           dict(part_axes=("data",), batch_axis="model")),
            "grid": ((1, ranks // 2, 2), ("pod", "data", "model"),
                     dict(part_axes=("pod", "data"), batch_axis="model")),
            "replicated": ((ranks, 1), ("data", "model"),
                           dict(part_axes=(), batch_axis="data"))}


def run_entries(eng, index, q, k) -> dict:
    """Every entry point once to warm it and once timed: the timed call's
    results as numpy and its wall ms."""
    import torch
    snap = eng.refresh_snapshot(index)
    calls = {"bruteforce": lambda: eng.search_bruteforce(q, snap),
             "fixed": lambda: eng.search_fixed(q, snap),
             "adaptive": lambda: eng.search_adaptive(q, snap),
             "batch": lambda: eng.search_batch(index, q, k,
                                               recall_target=ENGINE_TARGET)}
    out = {}
    for name in ENTRIES:
        res, wall, _ = warm_then_time(calls[name])
        out[f"{name}.wall_ms"] = np.asarray(wall)
        if name == "batch":
            for f in ("ids", "dists", "nprobe", "rounds",
                      "partitions_scanned"):
                out[f"batch.{f}"] = np.asarray(getattr(res, f))
        else:
            for f, v in zip(("d", "i", "r", "nprobe"), res):
                out[f"{name}.{f}"] = v.double().cpu().numpy() \
                    if v.is_floating_point() else v.cpu().numpy()
    del snap
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def profile_batch(eng, index, q, k) -> dict:
    """One warm ``search_batch`` under ``torch.profiler`` (card only; no
    trace is kept: four ranks' traces outgrow what a chip run brings
    back), with the host time of its planning and of its planned
    scans."""
    ms = {}

    def call():
        ms.clear()
        with host_timers(ms):
            return eng.search_batch(index, q, k, recall_target=ENGINE_TARGET)
    prof = profile_call(call, "search_batch", out_dir=None)
    return {"wall_ms": prof["wall_ms_profiled"],
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"],
            "plan_host_ms": ms.get("plan", 0.0),
            "scan_host_ms": ms.get("scan", 0.0),
            "top": prof["top"][:5]}


def engine_for(mesh, k, **kw):
    from repro_torch.core import EngineConfig, ShardedQuakeEngine
    return ShardedQuakeEngine(mesh, EngineConfig(
        k=k, nprobe=ENGINE_NPROBE, chunk=ENGINE_CHUNK,
        max_rounds=ENGINE_ROUNDS, recall_target=ENGINE_TARGET,
        scan_impl="union_cuda", **kw))


def rank_main(rank: int, args, root: str, init: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core import QuakeIndex
    from repro_torch.launch.mesh import Mesh
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{init}",
                            world_size=args.ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        dev = f"cuda:{rank % torch.cuda.device_count()}" if cuda else "cpu"
        index = QuakeIndex.load(root, device=dev)
        q = np.load(os.path.join(args.out, "queries.npy"))
        out, profiles = {}, {}
        with record_plans([]) as plans:
            for name, (shape, axes, kw) in layouts(args.ranks).items():
                mesh = Mesh(shape, axes, device=args.device)
                eng = engine_for(mesh, args.k, **kw)
                res = run_entries(eng, index, q, args.k)
                out.update({f"{name}.{key}": v for key, v in res.items()})
                out[f"{name}.shard"] = np.asarray(
                    [eng.part_index, eng.batch_index, eng.n_part_shards,
                     eng.n_batch_shards])
                if cuda:
                    profiles[name] = profile_batch(eng, index, q, args.k)
                del eng
        # the plans every rank scanned must agree
        out["plans"] = plans_agree(plans, dev)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
        with open(os.path.join(args.out, f"profile{rank}.json"), "w") as f:
            json.dump(profiles, f, indent=1)
    finally:
        dist.destroy_process_group()


def same_topk(name, d_got, i_got, d_ref, i_ref):
    """``compare_topk`` on two results as numpy arrays."""
    import torch
    compare_topk(name, *(torch.as_tensor(a) for a in (d_got, i_got, d_ref,
                                                      i_ref)))
    return int((i_got != i_ref).sum())


def profile_line(p: dict) -> str:
    busy = p["device_busy_ms"]
    return (f"wall {p['wall_ms']:.1f} ms, device busy "
            + ("not measured" if busy is None else f"{busy:.1f} ms")
            + f", host planning {p['plan_host_ms']:.1f} ms, host in the "
            f"planned scans {p['scan_host_ms']:.1f} ms")


def main() -> int:
    args = parse_args()
    import torch
    from repro_torch.core import QuakeIndex
    from repro_torch.data import datasets
    from repro_torch.launch.mesh import Mesh
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"engine_ranks: {args.ranks} ranks need as many cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.ranks % 2:
        print("engine_ranks: --ranks must be even (the grid layout)",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = card_line() if args.device == "cuda" else "cpu (no card)"
    dev = args.device
    t0 = time.perf_counter()
    ds = datasets.clustered(args.n, args.dim, n_clusters=args.clusters,
                            power=0.5, seed=args.seed)
    q = datasets.queries_near(ds, args.batch, seed=args.seed + 1)
    np.save(os.path.join(args.out, "queries.npy"), q)
    gt = ds.ground_truth(q, args.k, device=dev)
    index = QuakeIndex.build(ds.vectors, device=dev)
    record = {"card": card, "args": vars(args),
              "P": index.levels[0].num_partitions,
              "setup_s": time.perf_counter() - t0}
    one = engine_for(Mesh((1, 1), ("data", "model"), device=dev), args.k)
    ref = run_entries(one, index, q, args.k)
    if dev == "cuda":
        record["reference_batch_profile"] = profile_batch(
            one, index, q, args.k)
    del one
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "index")
        index.save(root)
        del index
        if dev == "cuda":
            torch.cuda.empty_cache()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, args, root, os.path.join(tmp, "init")))
                 for r in range(args.ranks)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        for p in procs:
            if p.is_alive():
                p.kill()
        record["ranks_s"] = time.perf_counter() - t
        if any(p.exitcode != 0 for p in procs):
            print(f"engine_ranks: rank exit codes "
                  f"{[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
    ranks = [dict(np.load(os.path.join(args.out, f"rank{r}.npz")))
             for r in range(args.ranks)]
    for r, got in enumerate(ranks[1:], 1):    # the whole batch everywhere
        for key, v in ranks[0].items():
            if not (key.endswith(".wall_ms") or key.endswith(".shard")) \
                    and not np.array_equal(got[key], v):
                raise SystemExit(f"rank {r} differs from rank 0 at {key}")
    got = ranks[0]
    record["reference"] = {
        name: {"recall@k": recall_at(ref[f"{name}.i" if name != "batch"
                                         else "batch.ids"], gt),
               "wall_ms": float(ref[f"{name}.wall_ms"])}
        for name in ENTRIES}
    print(f"engine_ranks [{card}]: P = {record['P']}, B = {args.batch}, "
          f"k = {args.k}")
    print(f"  one rank: " + ", ".join(
        f"{n} recall {v['recall@k']:.4f} {v['wall_ms']:.1f} ms"
        for n, v in record["reference"].items()))
    profiles = [json.load(open(os.path.join(args.out, f"profile{r}.json")))
                for r in range(args.ranks)]
    if "reference_batch_profile" in record:
        print(f"  one rank search_batch: "
              f"{profile_line(record['reference_batch_profile'])}")
    record["layouts"] = {}
    for name in layouts(args.ranks):
        row = {"shards": [r[f"{name}.shard"].tolist() for r in ranks]}
        for entry in ENTRIES:
            ids = got[f"{name}.batch.ids" if entry == "batch"
                      else f"{name}.{entry}.i"]
            row[entry] = {"recall@k": recall_at(ids, gt),
                          "wall_ms_by_rank": [float(r[f"{name}.{entry}"
                                                      f".wall_ms"])
                                              for r in ranks]}
        for entry in ("bruteforce", "batch") + (
                ("fixed",) if name == "replicated" else ()):
            if entry == "batch":
                d_got, i_got = got[f"{name}.batch.dists"], \
                    got[f"{name}.batch.ids"]
                d_ref, i_ref = ref["batch.dists"], ref["batch.ids"]
                for f in ("rounds", "partitions_scanned", "nprobe"):
                    if not np.array_equal(got[f"{name}.batch.{f}"],
                                          ref[f"batch.{f}"]):
                        raise SystemExit(f"{name} search_batch: {f} "
                                         f"differs from one rank's")
            else:
                d_got, i_got = got[f"{name}.{entry}.d"], \
                    got[f"{name}.{entry}.i"]
                d_ref, i_ref = ref[f"{entry}.d"], ref[f"{entry}.i"]
            row[entry]["ids_differing_at_near_ties"] = same_topk(
                f"{name} {entry}", d_got, i_got, d_ref, i_ref)
        if f"{name}.adaptive.nprobe" in got:
            row["adaptive"]["mean_nprobe"] = float(
                got[f"{name}.adaptive.nprobe"].mean())
        if profiles[0]:
            row["batch_profile_by_rank"] = [p[name] for p in profiles]
        record["layouts"][name] = row
        print(f"  {name} {row['shards'][0]}: " + ", ".join(
            f"{e} recall {row[e]['recall@k']:.4f} "
            f"{max(row[e]['wall_ms_by_rank']):.1f} ms" for e in ENTRIES))
        for r, p in enumerate(row.get("batch_profile_by_rank", [])):
            print(f"    rank {r} search_batch: {profile_line(p)}")
    record["plans_hashed"] = int(len(got["plans"]))
    record["total_s"] = time.perf_counter() - t0
    with open(os.path.join(args.out, "record.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"engine_ranks: all layouts held in {record['total_s']:.1f} s")
    print(json.dumps({"ok": True, "ranks": args.ranks, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
