"""The model stack's serving paths: the layers, the dense transformer
(prefill and decode), the four recsys models (DIN, SASRec, two-tower,
DLRM RM-2) with their serve and retrieval functions, and the conversion
of the JAX package's weights."""
from .convert import (config_from_jax, params_from_jax,
                      recsys_config_from_jax, recsys_params_from_jax)
from .recsys import (DIN, DLRM, MODELS, DINConfig, DLRMConfig, SASRec,
                     SASRecConfig, TwoTower, TwoTowerConfig, recsys_retrieval,
                     recsys_serve)
from .transformer import (MoEConfig, Transformer, TransformerConfig,
                          active_param_count, param_count)

__all__ = ["DIN", "DINConfig", "DLRM", "DLRMConfig", "MODELS", "MoEConfig",
           "SASRec", "SASRecConfig", "Transformer", "TransformerConfig",
           "TwoTower", "TwoTowerConfig", "active_param_count",
           "config_from_jax", "param_count", "params_from_jax",
           "recsys_config_from_jax", "recsys_params_from_jax",
           "recsys_retrieval", "recsys_serve"]
