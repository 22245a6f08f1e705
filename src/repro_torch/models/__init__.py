"""The LM serving path: layers, the dense transformer (prefill and
decode), and the conversion of the JAX package's weights."""
from .convert import config_from_jax, params_from_jax
from .transformer import (MoEConfig, Transformer, TransformerConfig,
                          active_param_count, param_count)

__all__ = ["MoEConfig", "Transformer", "TransformerConfig",
           "active_param_count", "config_from_jax", "param_count",
           "params_from_jax"]
