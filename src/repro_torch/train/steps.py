"""Train and serve step builders: microbatch accumulation, a one-time cast
of the parameters per step, and the explicit data-parallel step with
int8 error-feedback gradient compression (the JAX package's
``train/steps.py`` in PyTorch).

A step takes the model itself (an ``nn.Module``), its ``AdamWState`` and
a batch, and updates both in place.  Gradients are taken with respect to
stand-in leaves that share the parameters' storage, or hold their casts:
``swapped`` puts them in the model's place for the forward and the
backward (a checkpointed layer recomputes inside the backward, so it
must find them there too), and the f32 masters are written only by the
optimizer.  ``jit_train_step`` (explicit shardings) waits for the
sharding specs.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import optimizer as opt

Tensor = torch.Tensor
LossFn = Callable[[nn.Module, Any], Tensor]
# the profiler range around the optimizer update of a train step
UPDATE_RANGE = "train.apply_update"


@contextlib.contextmanager
def swapped(model: nn.Module, tensors: Mapping[str, Tensor]):
    """Inside the context, ``model``'s parameters named in ``tensors`` are
    those tensors (the reference's pure ``loss_fn(params, batch)`` over a
    module that holds its weights); the parameters come back on exit."""
    saved = []
    try:
        for name, t in tensors.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            saved.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield model
    finally:
        for owner, leaf, p in reversed(saved):
            owner._parameters[leaf] = p


def to_device(batch, device):
    """A batch (a dict, list or tuple of numpy arrays, tensors or numpy
    scalars; None) with every array a tensor on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, (np.ndarray, np.generic, Tensor)):
        return torch.as_tensor(batch, device=device)
    return batch


def _rows(batch, sl: slice):
    """Rows ``sl`` of every array of the batch (along axis 0)."""
    if isinstance(batch, dict):
        return {k: _rows(v, sl) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_rows(v, sl) for v in batch)
    return batch if batch is None else batch[sl]


def _leaves(model: nn.Module, cast_dtype=None) -> Dict[str, Tensor]:
    """Leaves to differentiate, one per floating parameter: the parameter
    detached (its storage), or its cast to ``cast_dtype``."""
    out = {}
    for name, p in model.named_parameters():
        if not p.is_floating_point():
            continue
        t = p.detach()
        if cast_dtype is not None:
            t = t.to(cast_dtype)
        out[name] = t.requires_grad_()
    return out


def _grad(loss_fn: LossFn, model: nn.Module, leaves: Dict[str, Tensor],
          batch) -> Tuple[Tensor, Dict[str, Tensor]]:
    with swapped(model, leaves), torch.enable_grad():
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(t) if g is None else g
        for (n, t), g in zip(leaves.items(), grads)}


def value_and_grad(loss_fn: LossFn, model: nn.Module, batch,
                   cast_dtype=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(``loss_fn(model, batch)``, its gradient by parameter name), the
    gradient in the leaves' dtype (``cast_dtype`` when given: the
    gradient of the cast, whose f32 copy is the masters' gradient)."""
    return _grad(loss_fn, model, _leaves(model, cast_dtype), batch)


def make_train_step(loss_fn: LossFn, opt_cfg: opt.AdamWConfig,
                    microbatches: int = 1, cast_dtype=None):
    """Returns ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, updating the model's parameters and the state in place;
    the batch's arrays go to the model's device first.

    As the reference: ``microbatches`` > 1 splits the batch on axis 0 as
    ``x[:mb * n].reshape(n, mb, ...)`` (trailing rows dropped), the
    gradients accumulate in f32 and loss and gradients are divided by n.
    ``cast_dtype`` casts the floating parameters once per step before the
    loss; the gradient of each cast, taken to f32, is the master's.
    Metrics: ``loss``, ``grad_norm`` and ``lr``, tensors on the device."""
    def step(model: nn.Module, opt_state: opt.AdamWState, batch):
        batch = to_device(batch, opt_state.step.device)
        leaves = _leaves(model, cast_dtype)
        if microbatches == 1:
            loss, g = _grad(loss_fn, model, leaves, batch)
            grads = {n: g.pop(n).float() for n in list(g)}
        else:
            n = microbatches
            mb = next(iter(_arrays(batch))).shape[0] // n
            loss = torch.zeros((), device=opt_state.step.device)
            grads = {k: torch.zeros(t.shape, dtype=torch.float32,
                                    device=t.device)
                     for k, t in leaves.items()}
            for i in range(n):
                li, g = _grad(loss_fn, model, leaves,
                              _rows(batch, slice(i * mb, (i + 1) * mb)))
                loss = loss + li
                for k in list(g):
                    grads[k].add_(g.pop(k))
            loss = loss / n
            for t in grads.values():
                t.div_(n)
        del leaves
        with torch.profiler.record_function(UPDATE_RANGE):
            model, opt_state, info = opt.apply_update(model, grads,
                                                      opt_state, opt_cfg)
        return model, opt_state, {"loss": loss, **info}

    return step


def _arrays(batch):
    """The arrays of a batch tree, in order."""
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _arrays(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _arrays(v)
    elif batch is not None:
        yield batch


def make_compressed_dp_step(loss_fn: LossFn, opt_cfg: opt.AdamWConfig,
                            mesh, dp_axes=("pod", "data")):
    """The explicit data-parallel step over ``mesh`` (``launch.mesh.Mesh``:
    a torch.distributed group, or one device): every rank holds the
    whole model, takes its rows of the global batch (``B / n`` rows, in
    the ``dp_axes``' row-major order, as ``shard_map`` splits it), and the
    gradients are all-reduced with int8 error-feedback compression
    (``optimizer.compressed_psum``: an int32 SUM of the codes, a MAX of
    the scales); the loss is the ranks' mean.  Returns ``step(model,
    opt_state, residual, batch) -> (model, opt_state, residual,
    metrics)``, the residuals (``optimizer.init_residual``) updated in
    place."""
    def step(model: nn.Module, opt_state: opt.AdamWState,
             residual: Dict[str, Tensor], batch):
        batch = to_device(batch, opt_state.step.device)
        n = mesh.axis_size(dp_axes)
        rows = next(iter(_arrays(batch))).shape[0] // n
        i = mesh.index(dp_axes)
        loss, g = value_and_grad(loss_fn, model,
                                 _rows(batch, slice(i * rows,
                                                    (i + 1) * rows)))
        grads, new_res = opt.compressed_psum(g, residual, mesh, dp_axes)
        del g
        for k, r in new_res.items():
            residual[k].copy_(r)
        loss = mesh.psum(loss.reshape(1), dp_axes).reshape(()) / n
        model, opt_state, info = opt.apply_update(model, grads, opt_state,
                                                  opt_cfg)
        return model, opt_state, residual, {"loss": loss, **info}

    return step


def make_serve_step(apply_fn: Callable[..., Any]):
    """Wrap a forward for serving: ``apply_fn(model, *inputs)`` without
    gradients."""
    @functools.wraps(apply_fn)
    def serve(model, *inputs):
        with torch.no_grad():
            return apply_fn(model, *inputs)
    return serve
