"""End-to-end LM training driver: the JAX package's ``launch/train.py``
in PyTorch, on one device.

Trains an LM preset on the synthetic token pipeline with microbatch
accumulation, AdamW with the warmup and cosine schedule, asynchronous
checkpoints and the fault-tolerant supervisor:

    PYTHONPATH=src python -m repro_torch.launch.train --preset lm-20m \\
        --steps 200

It runs on ``--device`` (default ``cuda``, which raises when CUDA is
absent; ``--device cpu`` runs it on the CPU).  A checkpoint directory
that already holds checkpoints is resumed from its latest.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.device import resolve_device
from ..data.pipelines import TokenPipeline
from ..models import transformer as tr
from ..train import (AdamWConfig, CheckpointManager, LoopConfig, init_state,
                     train_loop)
from ..train import steps as steps_mod
from ..train.loop import LoopReport

PRESETS = {
    # ~100M-class config scaled to what one device steps through quickly;
    # a larger preset changes nothing else
    "lm-100m": tr.TransformerConfig(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
        vocab_size=32768, compute_dtype=torch.float32, remat=False),
    "lm-20m": tr.TransformerConfig(
        n_layers=8, d_model=384, n_heads=8, n_kv_heads=2, d_ff=1536,
        vocab_size=8192, compute_dtype=torch.float32, remat=False),
    "lm-tiny": tr.TransformerConfig(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
        vocab_size=2048, compute_dtype=torch.float32, remat=False),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="lm-tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="results/ckpt_train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(preset: str, batch: int, seq: int, lr: float, steps: int,
          microbatches: int = 1, device="cuda"):
    """(state, step_fn, batch_at) of a run: the preset's model drawn from
    seed 0 on ``device`` with its AdamW state, the train step over
    ``lm_loss`` (warmup over a twentieth of the steps, at least 5), and the
    token pipeline's ``batch_at``; ``train_loop``'s arguments."""
    dev = resolve_device(device)
    cfg = PRESETS[preset]
    model = tr.Transformer(cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    ocfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                       total_steps=steps)
    step = steps_mod.make_train_step(
        lambda m, b: tr.lm_loss(m, b["tokens"]), ocfg, microbatches)

    def step_fn(state, b):
        m, o = state
        m, o, metrics = step(m, o, b)
        return (m, o), metrics
    pipe = TokenPipeline(cfg.vocab_size, batch, seq)
    return (model, init_state(model)), step_fn, pipe.batch_at


def main(argv=None) -> LoopReport:
    """Train, print the supervisor's log and summary, and return its
    report."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    print(f"device: {dev}; arch: {args.preset} "
          f"(~{tr.param_count(cfg)/1e6:.1f}M params)")
    state, step_fn, batch_at = build(args.preset, args.batch, args.seq,
                                     args.lr, args.steps, args.microbatches,
                                     dev)
    ckpt = CheckpointManager(args.ckpt_dir)
    t0 = time.time()
    report = train_loop(state, step_fn, batch_at, ckpt,
                        LoopConfig(n_steps=args.steps,
                                   ckpt_every=args.ckpt_every),
                        log=print)
    dt = time.time() - t0
    if report.losses:
        print(f"done: {len(report.losses)} steps in {dt:.1f}s, "
              f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}, "
              f"restarts={report.restarts}")
    return report


if __name__ == "__main__":
    main()
