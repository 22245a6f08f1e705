"""The training cells of the JAX package's ``configs/families.py``, as
plain data: the optimizer (``OPT_CFG``), the LM ``train_4k`` shape (full
and smoke) with ``build_lm``'s step settings, and the one-device form of
``_adapt_lm_cfg``.  The recsys ``train_batch`` shape is in
``recsys_archs.RECSYS_SHAPES`` and the GNN's shapes in
``gnn_archs.GNN_SHAPES``; the registry's cells are built by
``families``."""
from __future__ import annotations

import dataclasses

from ..models.transformer import TransformerConfig
from ..train.optimizer import AdamWConfig

OPT_CFG = AdamWConfig()

LM_TRAIN_SHAPES = {"train_4k": dict(kind="train", seq=4096, batch=256)}
LM_TRAIN_SMOKE_SHAPES = {"train_4k": dict(kind="train", seq=64, batch=2)}
# build_lm's step: the chunked loss over 512 positions, 2 microbatches
# (1 at the smoke shape), the parameters cast to the compute dtype once
# a step
LM_LOSS_CHUNK, LM_MICROBATCHES = 512, 2


def adapt_lm_cfg(cfg: TransformerConfig, tp: int = 1) -> TransformerConfig:
    """``_adapt_lm_cfg``'s attention choice: the grouped path when a
    ``tp``-way model axis divides the kv heads or the group width (always
    on one device), the repeat path otherwise."""
    rep = cfg.n_heads // cfg.n_kv_heads
    grouped = (cfg.n_kv_heads % tp == 0) or (rep % tp == 0)
    return dataclasses.replace(cfg, attn_grouped=grouped)


def lm_cast_dtype(cfg: TransformerConfig):
    """``build_lm``'s ``cast_dtype``: the compute dtype where it differs
    from the parameters' dtype, else None."""
    return cfg.compute_dtype if cfg.compute_dtype != cfg.param_dtype \
        else None
