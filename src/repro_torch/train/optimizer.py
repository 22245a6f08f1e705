"""AdamW with decoupled weight decay, global-norm clipping, a warmup and
cosine schedule, and error-feedback int8 gradient compression for the
data-parallel all-reduce: the JAX package's ``train/optimizer.py`` in
PyTorch, written out by hand (``torch.optim.AdamW`` and
``clip_grad_norm_`` differ from the reference; see ``apply_update``).

Parameters are a name -> tensor mapping (``dict(module.named_parameters())``
or a module, read through ``named``); the optimizer state keys its f32
moments by the same names.  Where the reference returns new trees, the
update here writes the parameters and the state in place, under
``no_grad``, and returns them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

Tensor = torch.Tensor
Params = Union[nn.Module, Mapping[str, Tensor]]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor                 # int32 scalar: updates applied so far
    m: Dict[str, Tensor]         # f32 first moments, by parameter name
    v: Dict[str, Tensor]         # f32 second moments


def named(params: Params) -> Dict[str, Tensor]:
    """The name -> tensor mapping of ``params`` (a module's parameters by
    their ``named_parameters`` names, or the mapping itself)."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32 on the step's
    device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Params) -> AdamWState:
    """Zero moments in f32 beside each parameter, and step 0."""
    p = named(params)
    dev = next(iter(p.values())).device if p else torch.device("cpu")
    zeros = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for n, t in p.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={n: z.clone() for n, z in zeros.items()})


def global_norm(tensors) -> Tensor:
    """sqrt of the sum over ``tensors`` (a mapping's values or an
    iterable) of their f32 sums of squares."""
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Mapping[str, Tensor], max_norm: float
                        ) -> Tuple[Dict[str, Tensor], Tensor]:
    """(grads times ``min(1, max_norm / max(norm, 1e-12))``, norm), new
    tensors."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale for n, g in grads.items()}, norm


@torch.no_grad()
def apply_update(params: Params, grads: Mapping[str, Tensor],
                 state: AdamWState, cfg: AdamWConfig
                 ) -> Tuple[Params, AdamWState, Dict[str, Tensor]]:
    """One AdamW update in place; returns (params, state, {"grad_norm",
    "lr"}).  As the reference: the gradients clipped by their global
    norm (``min(1, clip / max(norm, 1e-12))``, where ``clip_grad_norm_``
    takes ``clip / (norm + 1e-6)``); the step incremented first, the
    learning rate ``schedule(step)`` and the bias corrections ``1 -
    b**step`` in f32 at the new step; ``delta = m_hat / (sqrt(v_hat) +
    eps) + wd * p`` for every parameter, norms and embeddings included;
    ``p - lr * delta`` computed in f32 and cast to p's dtype."""
    p_named = named(params)
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    state.step.add_(1)
    stepf = state.step.float()
    lr = schedule(cfg, stepf)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for name, p in p_named.items():
        g = grads[name].float() * scale
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        delta = (m / b1c).div_(denom)
        del denom
        delta.add_(p.float(), alpha=cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float() - lr * delta.to(p.dtype).float())
    return params, state, {"grad_norm": norm, "lr": lr}


# ---------------------------------------------------------------------------
# Gradient compression (error feedback), for the explicit data-parallel step
# ---------------------------------------------------------------------------

def compress_int8(g: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-tensor symmetric int8 quantization; returns (q, scale).  Halves
    round to even, as ``jnp.round``."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: Tensor, scale: Tensor) -> Tensor:
    return q.float() * scale


def compressed_psum(grads: Mapping[str, Tensor],
                    residual: Mapping[str, Tensor], mesh, axes
                    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Error-feedback compressed all-reduce over ``mesh``'s ``axes``:
    (grad + residual) quantized to int8 with a scale of its own, the codes
    summed as int32 and the scales maxed across the ranks, the sum times
    the largest scale over the rank count; the local quantization error
    is the next step's residual.  Returns (mean gradients, residuals), new
    tensors."""
    n = mesh.axis_size(axes)
    out, new_res = {}, {}
    for name, g in grads.items():
        g32 = g.float() + residual[name]
        q, scale = compress_int8(g32)
        new_res[name] = g32 - decompress_int8(q, scale)
        summed = mesh.psum(q.to(torch.int32), axes)
        scale_max = mesh.pmax(scale.reshape(1), axes).reshape(())
        out[name] = summed.float() * scale_max / n
    return out, new_res


def init_residual(params: Params) -> Dict[str, Tensor]:
    return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in named(params).items()}
