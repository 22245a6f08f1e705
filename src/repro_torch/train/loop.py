"""Fault-tolerant training supervisor: the JAX package's ``train/loop.py``
in PyTorch.

The data pipeline is step-indexed (``data/pipelines.py``), so recovery
is: restore the latest checkpoint, resume at its manifest's step, and the
pipeline regenerates exactly the batches that followed.  Failures are
exceptions from the step (injectable through ``failure_injector``); the
supervisor restores and retries, a bounded number of times in a row.
Per-step wall time feeds an EWMA; steps slower than ``straggler_factor``
times it are counted and reported.

The reference's step is pure, so its ``init_state`` stays the initial
state.  Here the step updates the state in place: the supervisor keeps a
host copy of the initial state, taken before the first step, and a
restart with no checkpoint loads it back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from .checkpoint import CheckpointManager, load_into, snapshot

Pytree = Any


@dataclass
class LoopConfig:
    n_steps: int = 100
    ckpt_every: int = 25
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclass
class LoopReport:
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    restarts: int = 0
    stragglers: int = 0
    resumed_from: Optional[int] = None


def train_loop(init_state: Pytree, step_fn: Callable,
               batch_at: Callable[[int], Any], ckpt: CheckpointManager,
               cfg: LoopConfig,
               failure_injector: Optional[Callable[[int], None]] = None,
               log: Callable[[str], None] = lambda s: None) -> LoopReport:
    """``step_fn(state, batch) -> (state, metrics)`` updates ``state`` (any
    tree of tensors, e.g. ``(model, opt_state)``) in place.  The loop
    resumes from the latest checkpoint if there is one, checkpoints every
    ``ckpt_every`` steps and at the end, and returns the report; the
    trained state is ``init_state`` itself."""
    report = LoopReport()
    state = init_state
    pristine = snapshot(init_state)
    start = 0
    if ckpt.latest_step() is not None:
        start = ckpt.restore_into(state)["step"]
        report.resumed_from = start
        log(f"resumed from step {start}")

    ewma = None
    step = start
    attempts = 0
    while step < cfg.n_steps:
        try:
            if failure_injector is not None:
                failure_injector(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_at(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            report.losses.append(loss)
            report.step_times.append(dt)
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > cfg.straggler_factor * ewma and len(
                    report.step_times) > 3:
                report.stragglers += 1
                log(f"straggler step {step}: {dt:.3f}s vs ewma {ewma:.3f}s")
            step += 1
            attempts = 0
            if step % cfg.ckpt_every == 0 or step == cfg.n_steps:
                ckpt.save(step, state)
            if step % cfg.log_every == 0:
                log(f"step {step}: loss={loss:.4f} ({dt*1e3:.0f}ms)")
        except Exception as e:  # noqa: BLE001 — supervisor boundary
            attempts += 1
            report.restarts += 1
            log(f"step {step} failed ({e!r}); restart {attempts}")
            if attempts > cfg.max_restarts:
                raise
            if ckpt.latest_step() is not None:
                step = ckpt.restore_into(state)["step"]
            else:
                load_into(state, pristine)
                step = 0
    ckpt.wait()
    return report
