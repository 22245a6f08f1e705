"""The four recsys architectures of the JAX package's
``configs/recsys_archs.py`` (the published configs) and their smoke
configs, with the family's serving shapes (``configs/families.py``), as
plain data.  The registry (``configs/__init__.py``) names them and
builds their cells through ``families.build_recsys``."""
from __future__ import annotations

from ..models.recsys import (DINConfig, DLRMConfig, SASRecConfig,
                             TwoTowerConfig)

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=1_000_000),
}
RECSYS_SMOKE_SHAPES = {
    "train_batch": dict(kind="train", batch=32),
    "serve_p99": dict(kind="serve", batch=8),
    "serve_bulk": dict(kind="serve", batch=64),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_cand=512),
}


# -- DIN [arXiv:1706.06978] --------------------------------------------------

def din() -> DINConfig:
    return DINConfig(vocab=10_000_000, embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80))


def din_smoke() -> DINConfig:
    return DINConfig(vocab=1000, embed_dim=18, seq_len=50,
                     attn_mlp=(80, 40), mlp=(200, 80))


# -- SASRec [arXiv:1808.09781] ------------------------------------------------

def sasrec() -> SASRecConfig:
    return SASRecConfig(vocab=1_000_000, embed_dim=50, n_blocks=2,
                        n_heads=1, seq_len=50)


def sasrec_smoke() -> SASRecConfig:
    return SASRecConfig(vocab=1000, embed_dim=50, n_blocks=2, n_heads=1,
                        seq_len=50)


# -- Two-tower retrieval [RecSys'19 YouTube] ----------------------------------

def two_tower() -> TwoTowerConfig:
    return TwoTowerConfig(user_vocab=10_000_000, item_vocab=10_000_000,
                          embed_dim=256, tower_mlp=(1024, 512, 256))


def two_tower_smoke() -> TwoTowerConfig:
    return TwoTowerConfig(user_vocab=1000, item_vocab=1000, embed_dim=256,
                          tower_mlp=(1024, 512, 256))


# -- DLRM RM-2 [arXiv:1906.00091] ----------------------------------------------

def dlrm_rm2() -> DLRMConfig:
    return DLRMConfig(n_dense=13, n_sparse=26, vocab=5_000_000,
                      embed_dim=64, bot_mlp=(512, 256, 64),
                      top_mlp=(512, 512, 256, 1))


def dlrm_smoke() -> DLRMConfig:
    return DLRMConfig(n_dense=13, n_sparse=26, vocab=1000, embed_dim=64,
                      bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


# the reference's model names -> (published config, smoke config)
ARCHS = {"din": (din, din_smoke), "sasrec": (sasrec, sasrec_smoke),
         "two-tower-retrieval": (two_tower, two_tower_smoke),
         "dlrm-rm2": (dlrm_rm2, dlrm_smoke)}
