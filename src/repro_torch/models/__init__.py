"""The model stack: the layers, the transformer (dense and MoE; prefill,
decode, and the training forward and losses), the four recsys models
(DIN, SASRec, two-tower, DLRM RM-2) with their serve, retrieval and
training losses, the GAT forward and losses, and the conversion of the
JAX package's weights, gradients and optimizer state."""
from .convert import (config_from_jax, gnn_config_from_jax,
                      gnn_params_from_jax, params_from_jax,
                      recsys_config_from_jax, recsys_params_from_jax)
from .gnn import GAT, GATConfig
from .recsys import (DIN, DLRM, MODELS, DINConfig, DLRMConfig, SASRec,
                     SASRecConfig, TwoTower, TwoTowerConfig, recsys_retrieval,
                     recsys_serve)
from .transformer import (MoEConfig, Transformer, TransformerConfig,
                          active_param_count, moe_ffn, param_count)

__all__ = ["DIN", "DINConfig", "DLRM", "DLRMConfig", "GAT", "GATConfig",
           "MODELS", "MoEConfig", "SASRec", "SASRecConfig", "Transformer",
           "TransformerConfig", "TwoTower", "TwoTowerConfig",
           "active_param_count", "config_from_jax", "gnn_config_from_jax",
           "gnn_params_from_jax", "moe_ffn", "param_count",
           "params_from_jax", "recsys_config_from_jax",
           "recsys_params_from_jax", "recsys_retrieval", "recsys_serve"]
