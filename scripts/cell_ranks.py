#!/usr/bin/env python3
"""The registry's smoke cells on four ranks, held against one rank.

    python scripts/cell_ranks.py                        # 4 cards, NCCL
    PYTHONPATH=src python scripts/cell_ranks.py --device cpu   # gloo, CPU

Four processes (NCCL on CUDA, one card each; gloo on the CPU) form a
(1, 2, 2) mesh over ("pod", "data", "model").  Each builds every smoke
cell of the registry twice on its device: on that mesh, and on a one-rank
view of a (1, 1, 1) mesh (no collective moves anything), the reference.
It draws the whole arguments from one seed, runs the one-rank program
on them and its own rank's program on its shards (``Cell.shard``), and
holds its outputs against its slice of the reference's (``out_specs``;
a prefill cache by the rank's kv heads):

- within 1e-5 * |x| + 1e-5; decode within 2^-8 * |x| + 1e-3 (its cache
  is bf16, as the reference's, and the softmax weights are rounded to
  bf16 before the PV product, so a denominator summed over the ranks in
  another order can move a weight by one bf16 ulp);
- brute force and the assignment: ids equal;
- the fixed-nprobe search: equal to the merge of each partition shard's
  own one-rank search (each shard probes ceil(nprobe / shards));
- the adaptive search: ascending, the true distances of the ids it
  returns (its rounds differ from one rank's by design).

It prints each rank's largest excess over the tolerance per cell (<= 0
passes) beside the card's name and power limit, and exits 1 if any cell
fails.  ``tests/test_torch_spmd.py`` runs the same ``rank_results`` on
four gloo ranks.
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

TOL = 1e-5
DECODE_REL, DECODE_ABS = 2.0 ** -8, 1e-3
SEED = 11


def clone(tree, cpu: bool = False):
    """A deep copy of a tree of tensors (dicts, lists, tuples, named
    tuples, dataclasses); with ``cpu``, detached copies on the CPU."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone() if cpu else tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v, cpu) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(v, cpu) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v, cpu) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{k: clone(getattr(tree, k), cpu)
                             for k in tree.__dataclass_fields__})
    return tree


def _pairs(a, b, path=""):
    import torch
    if isinstance(a, torch.Tensor):
        yield path, a, b
    elif isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}.{i}")


def max_excess(got, want, rel=TOL, abs_=TOL) -> float:
    """The largest ``|got - want| - (rel * |want| + abs_)`` over two trees
    (<= 0 within tolerance); shapes and NaNs must match."""
    import torch
    worst = -1.0
    for path, g, w in _pairs(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{path}: {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        g, w = g.double().cpu(), w.double().cpu()
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{path}: NaNs differ")
        ok = ~torch.isnan(w)
        if ok.any():
            e = ((g - w).abs() - rel * w.abs() - abs_)[ok].max().item()
            worst = max(worst, e)
    return worst


def _expected_piece(out_spec, want, mesh):
    from repro_torch.configs.base import local_piece
    from repro_torch.launch.mesh import P
    if isinstance(out_spec, P):
        return local_piece(want, out_spec, mesh)
    if isinstance(out_spec, dict):
        return {k: _expected_piece(out_spec[k], want[k], mesh)
                for k in out_spec}
    if isinstance(out_spec, tuple) and hasattr(out_spec, "_fields"):
        return type(out_spec)(*(_expected_piece(s, w, mesh)
                                for s, w in zip(out_spec, want)))
    return tuple(_expected_piece(s, w, mesh)
                 for s, w in zip(out_spec, want))


def _ascending_true(got, q, snap) -> bool:
    """Each row ascending, each distance the true squared L2 distance of
    its id's vector."""
    d, ids = got[0].cpu(), got[1].cpu()
    x = snap.data.reshape(-1, snap.data.shape[-1]).cpu().double()
    pos = {int(v): i for i, v in enumerate(snap.ids.reshape(-1).tolist())}
    q = q.cpu().double()
    for b in range(d.shape[0]):
        row = [(float(d[b, j]), int(ids[b, j])) for j in range(d.shape[1])
               if int(ids[b, j]) >= 0]
        if any(row[j][0] > row[j + 1][0] for j in range(len(row) - 1)):
            return False
        for dist_, i in row:
            true = float(((x[pos[i]] - q[b]) ** 2).sum())
            if abs(true - dist_) > 1e-3 * (abs(true) + 1):
                return False
    return True


def _fixed_by_shards(full, cfg, one, n: int):
    """Each partition shard's own one-rank ``search_fixed`` (its share of
    nprobe), merged."""
    import dataclasses
    import torch
    from repro_torch.core.distributed import ShardedQuakeEngine
    q, snap = full
    p_l = snap.data.shape[0] // n
    parts = []
    for s in range(n):
        blk = type(snap)(**{
            f: (t if f == "beta_table" or t is None
                else t[s * p_l:(s + 1) * p_l])
            for f, t in vars(snap).items()})
        eng = ShardedQuakeEngine(one, dataclasses.replace(
            cfg, nprobe=-(-cfg.nprobe // n)))
        parts.append(eng.search_fixed(q, blk))
    d = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1)
    v, sel = torch.sort(d, dim=1, stable=True)
    return v[:, :cfg.k], torch.gather(i, 1, sel)[:, :cfg.k]


def expected_piece(cell, want, mesh):
    """This rank's piece of a whole-mesh result ``want`` of ``cell`` (built
    on ``mesh``): by ``out_specs``, and a prefill cache by the rank's
    batch rows and the kv heads it computed (``spmd.layout``)."""
    from repro_torch.configs.base import local_piece
    from repro_torch.models import spmd
    from repro_torch.models.transformer import TransformerConfig
    if isinstance(cell.config, TransformerConfig) \
            and len(cell.args) == 2:                        # prefill
        lay = spmd.layout(cell.config, mesh)
        dp = mesh.present(cell.config.dp_axes)
        bl = want[0].shape[0] // mesh.axis_size(dp)
        b0 = mesh.index(dp) * bl
        return (local_piece(want[0], cell.out_specs[0], mesh),
                tuple(c[:, b0:b0 + bl, :, lay.k0:lay.k1] for c in want[1]))
    return _expected_piece(cell.out_specs, want, mesh)


def cell_kind(name: str, cell) -> str:
    """The cell's kind: "train", "prefill", "decode", "serve",
    "retrieval", "fixed", "adaptive", "brute" or "assign"."""
    d = cell.description.split()
    if d[0] == "quake":
        return "assign" if d[1] == "maintenance" else d[1]
    if d[0] == "gnn":
        return "train"
    return d[1]


def rank_results(device, mesh=None, outputs: dict = None) -> dict:
    """Every smoke cell on this rank of a (1, 2, 2) mesh (``mesh``, by
    default one over the initialized process group), against the
    one-rank program on ``device``: {cell: largest excess over its
    tolerance}.  ``outputs``, when given, gets each cell's outputs on the
    CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    if mesh is None:
        mesh = Mesh((1, 2, 2), ("pod", "data", "model"), device=device)
    dev = mesh.device
    one = Mesh((1, 1, 1), ("pod", "data", "model"), device=dev, rank=0)
    out = {}
    for name, spec in configs.REGISTRY.items():
        for shape in spec.shapes:
            c1 = spec.build(shape, one, smoke=True)
            full = c1.materialize(dev, torch.Generator(device=dev)
                                  .manual_seed(SEED))
            want = c1.fn(*clone(full))
            c4 = spec.build(shape, mesh, smoke=True)
            got = c4.fn(*c4.shard(clone(full)))
            key = f"{name}/{shape}"
            if outputs is not None:
                outputs[key] = clone(got, cpu=True)
            kind = cell_kind(name, c4)
            if kind == "adaptive":
                q, snap = full
                bl = q.shape[0] // mesh.axis_size(("model",))
                b0 = mesh.index(("model",)) * bl
                out[key] = -1.0 if _ascending_true(got, q[b0:b0 + bl],
                                                   snap) else 1.0
                continue
            if kind == "fixed":
                want = _fixed_by_shards(full, c4.config, one,
                                        mesh.axis_size(("pod", "data")))
            exp = expected_piece(c4, want, mesh)
            if kind in ("brute", "assign"):
                ids = 0 if kind == "assign" else 1   # (assignment, dist)
                same = torch.equal(got[ids].cpu(), exp[ids].cpu())
                out[key] = max(max_excess(got[1 - ids], exp[1 - ids]),
                               -1.0 if same else 1.0)
            elif kind == "decode":
                out[key] = max_excess(got, exp, DECODE_REL, DECODE_ABS)
            else:
                out[key] = max_excess(got, exp)
    return out


def rank_main(rank: int, device: str, init: str, outdir: str) -> None:
    import torch
    import torch.distributed as dist
    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{init}", world_size=4,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = rank_results(device)
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "cell_ranks"))
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and torch.cuda.device_count() < 4:
        print(f"cell_ranks: 4 ranks need 4 cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    if args.device == "cuda":
        from chip_smoke import card_line
        print(card_line())
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(
            r, args.device, os.path.join(tmp, "init"), args.out))
            for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        for p in procs:
            if p.is_alive():
                p.kill()
        if any(p.exitcode != 0 for p in procs):
            print(f"cell_ranks: rank exit codes "
                  f"{[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
    res = [json.loads(Path(args.out, f"rank{r}.json").read_text())
           for r in range(4)]
    bad = 0
    for key in res[0]:
        worst = max(r[key] for r in res)
        bad += worst > 0
        print(f"{key}: largest excess over the tolerance {worst:.3g}"
              f"{'  FAILED' if worst > 0 else ''}")
    print(f"cell_ranks: {len(res[0]) - bad} of {len(res[0])} cells held "
          f"on 4 {args.device} ranks")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
