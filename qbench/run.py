"""Run one cell of the benchmark and print its result line.

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m qbench.run`` works too.)  Needs an NVIDIA card: without
one, or with fewer than the cell asks for, it exits 2 and prints no
result.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last); the last lines of standard error are the
numbers compared with their limits.  It exits 3 and prints no result if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.

``qbench/calibrate.py`` reads the numbers the correctness limits are set
from.
"""
import os
import sys
import time

T0 = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __package__ in (None, ""):
    # run as a script: import qbench from the root, not from this folder
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "qbench":
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None):
    """Loaded modules (or ``names``) whose top-level name, the part before
    the first dot, is one of FORBIDDEN, compared whole: ``repro_torch`` is
    not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_lines(result):
    return [f"check {name} {c['value']!r} limit {c['limit']!r}"
            for name, c in result["checks"].items()]


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(1, str(ROOT / "src"))
    # one process with few host threads: a steadier load on a shared host
    # (set before numpy and torch are imported)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = "4"
    os.environ["USE_FLAX"] = "0"
    from qbench import harness, spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("qbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"qbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"qbench: forbidden modules were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
