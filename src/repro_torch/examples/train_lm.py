"""End-to-end LM training: the train-N-steps example.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        --preset lm-100m --steps 300

Drives ``repro_torch.launch.train`` (the JAX package's
``examples/train_lm.py``): microbatch accumulation, AdamW with the warmup
and cosine schedule, asynchronous atomic checkpoints and the
fault-tolerant supervisor (restore and replay).  With no arguments but
``--device`` it runs the quick ``lm-tiny`` preset for 60 steps; the
arguments otherwise go to ``launch.train`` as they are.  On the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from ..launch.train import main as train_main

DEFAULT_ARGV = ["--preset", "lm-tiny", "--steps", "60", "--batch", "8",
                "--seq", "128", "--ckpt-every", "25"]


def run(argv=None, device=None) -> dict:
    """``launch.train.main`` on ``argv`` (``DEFAULT_ARGV`` when empty),
    with ``--device device`` appended when given; returns the run's
    steps, first and last loss, restarts and seconds."""
    argv = list(argv) if argv else list(DEFAULT_ARGV)
    if device is not None:
        argv += ["--device", str(device)]
    t0 = time.perf_counter()
    rep = train_main(argv)
    return {"steps": len(rep.losses),
            "loss_first": rep.losses[0] if rep.losses else None,
            "loss_last": rep.losses[-1] if rep.losses else None,
            "restarts": rep.restarts, "resumed_from": rep.resumed_from,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)
    return run(rest, args.device)


if __name__ == "__main__":
    main()
