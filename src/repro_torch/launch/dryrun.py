"""Multi-pod dry-run: every (architecture x shape) cell counted for one
rank of the production meshes (the reference's ``launch/dryrun.py``).

For each cell and each mesh (single pod 16 x 16, multi-pod 2 x 16 x 16)
it builds rank 0's program (``configs``' ``Cell``) and counts it on the
``meta`` device (``Cell.count``): argument bytes, the peak of live
temporaries, FLOPs, unfused bytes accessed and the collectives the mesh
records; then the roofline terms on an H100 (``roofline.analysis``).
A cell fits when its arguments and peak temporaries come to at most the
card's 80 GB.  Results go to JSON.  Any failure is a fault of the
program, and the run exits 1.

The LM training cells are counted at depths 2 and 3 and extended
linearly to their depth (each layer is the same program; the counts are
exactly linear in the depth), since a meta run of every layer's forward,
recompute and backward takes minutes; their arguments are counted at
full depth.

Usage:
    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
    python -m repro_torch.launch.dryrun --arch quake-ann --multi-pod-only
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Dict

MESHES = {"single_pod": False, "multi_pod": True}
EXTRAPOLATE_FROM = (2, 3)


def _extend(a, b, steps: int):
    """``b + steps * (b - a)`` through nested dicts of numbers."""
    if isinstance(a, dict):
        return {k: _extend(a.get(k, 0), v, steps) for k, v in b.items()}
    if isinstance(b, bool) or not isinstance(b, (int, float)):
        return b
    out = b + steps * (b - a)
    return int(out) if isinstance(b, int) else float(out)


def count_cell(arch: str, shape: str, mesh) -> Dict:
    """The cell's count on ``mesh``, the LM training cells extended
    linearly in depth from ``EXTRAPOLATE_FROM``."""
    from ..configs import get_arch
    from ..configs.families import LM_SHAPES
    spec = get_arch(arch)
    cell = spec.build(shape, mesh)
    if spec.family == "lm" and LM_SHAPES[shape]["kind"] == "train":
        depth = spec.model_config().n_layers
        lo, hi = EXTRAPOLATE_FROM
        c_lo = spec.build(shape, mesh, layers=lo).count()
        c_hi = spec.build(shape, mesh, layers=hi).count()
        count = _extend(c_lo, c_hi, depth - hi)
        count["arguments"] = cell.argument_bytes()
        count["notes"] = list(c_hi["notes"]) + [
            f"depth {depth}: extended linearly from counts at {lo} and "
            f"{hi} layers"]
        count["description"] = cell.description
        return count
    return cell.count()


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             verbose: bool = True) -> Dict:
    from ..launch.mesh import make_production_mesh
    from ..roofline.analysis import analyze
    mesh = make_production_mesh(multi_pod)
    t0 = time.time()
    count = count_cell(arch, shape, mesh)
    result = analyze(count, mesh, arch=arch, shape=shape)
    result.update(count_s=round(time.time() - t0, 1),
                  description=count.get("description", ""))
    if verbose:
        print(f"  [OK] {arch} x {shape}: "
              f"{result['bytes_per_device_gb']:.2f} GB/dev"
              f"{'' if result['fits'] else ' (does not fit)'}, "
              f"{result['flops_per_device_tf']:.2f} TF/dev, "
              f"coll {result['collective_gb']:.3f} GB "
              f"(count {result['count_s']:.0f}s)")
        print(f"       dominant: {result['dominant']} | "
              f"t_comp {result['t_compute_ms']:.3f}ms (by dtype) "
              f"t_mem {result['t_memory_ms']:.3f}ms (unfused) "
              f"t_coll {result['t_collective_ms']:.3f}ms", flush=True)
    return result


def _job(key: str):
    mesh_name, arch, shape = key.split("/")
    try:
        return key, run_cell(arch, shape, MESHES[mesh_name])
    except Exception as e:  # noqa: BLE001 — report every failure
        traceback.print_exc()
        return key, {"error": repr(e)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted in parallel, one process each")
    args = ap.parse_args()
    from ..configs import REGISTRY

    meshes = [m for m in MESHES
              if not (args.multi_pod_only and m == "single_pod")
              and not (args.single_pod_only and m == "multi_pod")]
    cells = [(name, shape) for name, spec in REGISTRY.items()
             if not args.arch or name == args.arch
             for shape in spec.shapes
             if not args.shape or shape == args.shape]
    if not cells:
        raise SystemExit("no cells selected")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    keys = [f"{m}/{a}/{s}" for m in meshes for a, s in cells
            if not (args.skip_existing and f"{m}/{a}/{s}" in results
                    and "error" not in results[f"{m}/{a}/{s}"])]
    t0 = time.time()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
            # the slowest (LM training) cells first
            order = sorted(keys, key=lambda k: "train_4k" not in k)
            for key, res in pool.map(_job, order):
                results[key] = res
    else:
        for key in keys:
            print(f"=== {key}", flush=True)
            results[key] = _job(key)[1]
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)

    failures = [(k, r["error"]) for k, r in results.items() if "error" in r]
    print(f"\n{len(results) - len(failures)} cells OK, {len(failures)} "
          f"failed in {time.time() - t0:.1f} s -> {args.out}")
    for k, e in failures:
        print(f"  FAIL {k}: {e}")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
