"""Training substrate: AdamW (schedule, clipping, int8 error-feedback
gradient compression), step builders with microbatch accumulation and a
one-time cast of the parameters, atomic and asynchronous checkpoints,
and the fault-tolerant training supervisor (the JAX package's ``train/``
in PyTorch)."""
from . import checkpoint, loop, optimizer, steps  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .loop import LoopConfig, train_loop  # noqa: F401
from .optimizer import AdamWConfig, init_state  # noqa: F401
