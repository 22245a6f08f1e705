"""Carry the JAX package's LM, recsys and GNN weights and configs into
the port.

``params_from_jax`` takes the reference's layer-stacked parameter tree
(``init_params``'s dict, leaves as numpy arrays or anything
``np.asarray`` reads, leading axis L on the per-layer leaves) and returns
a ``Transformer`` holding the same weights; ``config_from_jax`` builds
the port's config from a dict of the reference config's fields
(``dataclasses.asdict`` of it).  ``recsys_params_from_jax`` and
``recsys_config_from_jax`` do the same for the four recsys models, and
``gnn_params_from_jax`` and ``gnn_config_from_jax`` for the GAT, whose
trees the port keeps name for name.  ``named_from_jax`` maps any tree of
a model's structure (its gradients, AdamW moments) onto the port's
parameter names, and ``adamw_state_from_jax`` a whole optimizer state.
This is how a JAX checkpoint's weights reach the port, and how the
parity tests give both packages one model and hold each gradient and
optimizer leaf against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .gnn import GAT, GATConfig
from .recsys import MODELS
from .transformer import MoEConfig, Transformer, TransformerConfig

# the reference's attention switch, which the port drops, and the MoE
# fields that the port's MoEConfig keeps (all but the reference's
# ``impl``)
DROPPED_FIELDS = ("attn_impl",)
MOE_FIELDS = tuple(f.name for f in dataclasses.fields(MoEConfig))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_BLOCK_LEAVES = {"ln1": ("ln1",), "ln2": ("ln2",),
                 "wq": ("attn", "wq"), "wk": ("attn", "wk"),
                 "wv": ("attn", "wv"), "wo": ("attn", "wo"),
                 "bq": ("attn", "bq"), "bk": ("attn", "bk"),
                 "bv": ("attn", "bv"), "w_gate": ("mlp", "w_gate"),
                 "w_up": ("mlp", "w_up"), "w_down": ("mlp", "w_down")}


def _torch_dtype(x) -> torch.dtype:
    """The torch dtype of a dtype given as a torch dtype, a numpy or JAX
    scalar type, a numpy dtype or a name."""
    if isinstance(x, torch.dtype):
        return x
    name = x if isinstance(x, str) else (getattr(x, "__name__", None)
                                         or np.dtype(x).name)
    return _DTYPES[name]


def config_from_jax(fields: Dict[str, Any]) -> TransformerConfig:
    """The port's config from the reference config's fields
    (``attn_impl`` and the MoE's ``impl`` dropped, dtypes made torch
    dtypes, ``dp_axes`` a tuple)."""
    f = {k: v for k, v in fields.items() if k not in DROPPED_FIELDS}
    if "dp_axes" in f:
        f["dp_axes"] = tuple(f["dp_axes"])
    moe = f.get("moe")
    if moe is not None and not isinstance(moe, MoEConfig):
        moe = moe if isinstance(moe, dict) else dataclasses.asdict(moe)
        f["moe"] = MoEConfig(**{k: moe[k] for k in MOE_FIELDS if k in moe})
    for k in ("param_dtype", "compute_dtype"):
        if k in f:
            f[k] = _torch_dtype(f[k])
    return TransformerConfig(**f)


def _f32(a) -> np.ndarray:
    # through f32: numpy has no bfloat16 that torch reads
    return np.array(a, dtype=np.float32)


def lm_named_from_jax(tree: Dict[str, Any], cfg: TransformerConfig
                      ) -> Dict[str, np.ndarray]:
    """A tree of the reference LM's structure (its parameters, their
    gradients, or AdamW moments), layer-stacked leaves unstacked, as f32
    numpy arrays by the port's parameter names (``blocks.3.wq``, ...).
    An MoE block's ``moe.*`` and ``shared_mlp.*`` leaves come from the
    trees of those names."""
    out = {k: _f32(tree[k]) for k in ("embed", "ln_f", "lm_head")}
    names = Transformer(cfg, device="meta", init=False).blocks
    for name, _ in (names[0].named_parameters() if len(names) else ()):
        leaf = tree
        for key in _BLOCK_LEAVES.get(name, name.split(".")):
            leaf = leaf[key]
        stacked = _f32(leaf)
        for i in range(cfg.n_layers):
            out[f"blocks.{i}.{name}"] = stacked[i]
    return out


def named_from_jax(tree, cfg=None) -> Dict[str, np.ndarray]:
    """A parameter-shaped tree of the reference (parameters, gradients or
    AdamW moments) as f32 numpy arrays by the port's parameter names: the
    LM's through ``lm_named_from_jax`` when ``cfg`` is a
    ``TransformerConfig``; the recsys models' and the GAT's, whose trees
    the port keeps name for name, by their dotted paths."""
    if isinstance(cfg, TransformerConfig):
        return lm_named_from_jax(tree, cfg)
    return {name: _f32(leaf) for name, leaf in _flatten(tree)}


def adamw_state_from_jax(state, cfg=None, device="cuda"):
    """The reference's ``AdamWState`` (step, m, v) as the port's, on
    ``device``: the step an int32 scalar, the moments f32 by parameter
    name (``named_from_jax``)."""
    from ..train.optimizer import AdamWState
    dev = torch.device(device)

    def moments(tree):
        return {n: torch.from_numpy(a).to(dev)
                for n, a in named_from_jax(tree, cfg).items()}
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=moments(state.m), v=moments(state.v))


def params_from_jax(params: Dict[str, Any], cfg: TransformerConfig,
                    device="cuda", dtype: Optional[torch.dtype] = None
                    ) -> Transformer:
    """A ``Transformer`` on ``device`` holding ``params``' weights, stored
    in ``dtype`` (``cfg.param_dtype`` by default)."""
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    model = Transformer(cfg, device=device, init=False)
    model.load_state_dict({n: torch.from_numpy(a) for n, a in
                           lm_named_from_jax(params, cfg).items()})
    return model


def recsys_config_from_jax(model_name: str, fields: Dict[str, Any]):
    """The port's config of recsys model ``model_name`` (the reference's
    registry name: "din", "sasrec", "two-tower-retrieval", "dlrm-rm2")
    from the reference config's fields, ``tp_axis`` dropped and tuples
    kept as tuples."""
    return MODELS[model_name][0](**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in fields.items() if k != "tp_axis"})


def _flatten(tree, prefix=""):
    """(dotted name, leaf) of a nested dict/list tree, as
    ``state_dict`` names a module's ParameterLists and ModuleLists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}{k}.")


def recsys_params_from_jax(model_name: str, params: Dict[str, Any], cfg,
                           device="cuda"):
    """The port's ``model_name`` model on ``device`` holding ``params``
    (the reference's init tree, leaves as numpy arrays or anything
    ``np.asarray`` reads) in f32; the two trees must name the same
    tensors."""
    model = MODELS[model_name][1](cfg, device=device, init=False)
    model.load_state_dict({n: torch.from_numpy(a)
                           for n, a in named_from_jax(params).items()})
    return model


def gnn_config_from_jax(fields: Dict[str, Any]) -> GATConfig:
    """The port's GAT config from the reference config's fields
    (``dp_axes`` dropped)."""
    return GATConfig(**{k: v for k, v in fields.items() if k != "dp_axes"})


def gnn_params_from_jax(params: Dict[str, Any], cfg: GATConfig,
                        device="cuda") -> GAT:
    """A ``GAT`` on ``device`` holding ``params`` (the reference's
    ``init_params`` tree, ``{"layers": [{"w", "a_src", "a_dst", "b"},
    ...]}``) in f32."""
    model = GAT(cfg, device=device, init=False)
    model.load_state_dict({n: torch.from_numpy(a)
                           for n, a in named_from_jax(params).items()})
    return model
