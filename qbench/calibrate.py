"""The readings a cell's correctness limits are set from, in one process on
the card: the program's numbers on many seeds (the lower readings) and
the TF32 control's (the upper readings), each a short window at the
cell's own load.

    python3 qbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 5

Prints one JSON line per run: the seed, whether it was the control, the
checks and ``correct``."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __package__ in (None, ""):
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "qbench":
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(1, str(ROOT / "src"))
    import torch
    from qbench import harness, spec
    if not torch.cuda.is_available():
        print("qbench: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        r = harness.run_cell(cell, seed, args.seconds, False,
                             t_start=time.perf_counter(), control=control)
        print(json.dumps({"seed": seed, "control": control,
                          "correct": r["correct"],
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()},
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}),
              flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
