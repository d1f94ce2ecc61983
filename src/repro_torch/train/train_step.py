"""Training step: microbatched gradient accumulation + AdamW — port of
``repro.train.train_step`` for one device.

The loss and its gradients come from ``torch.autograd.grad`` on detached
leaf views of the parameters (no copy); the step then writes its update
into the parameters and optimizer state it was given, as the reference
launcher's jit with donated arguments does. Microbatching follows the
reference's scan: the batch splits along its leading dim as
``(nm, B / nm)``, the gradients are summed in f32 and scaled by
``1 / nm``, the loss averaged; with one microbatch the gradients keep the
parameters' dtype, as ``jax.value_and_grad`` gives them. The forward runs
the plain ops: the kernels have no backward (``api.lm_loss`` raises for
``use_kernels`` under autograd), as the reference trains.

The wire-compressed gradient all-reduce across a mesh is ROADMAP.md queue
1 item 14; ``compress_grads`` without a mesh is the local error-feedback
model inside ``apply_updates``, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as model_api
from repro_torch.optim.optimizer import AdamWConfig, apply_updates
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

_ITEM_14 = ("the wire-compressed gradient collective over a mesh is "
            "ROADMAP.md queue 1 item 14 (dist)")


def batch_to(batch: dict, device) -> dict:
    """The batch's arrays (numpy, from the data pipeline, or tensors) as
    tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _device(params):
    return tree_leaves(params)[0].device


def loss_and_grads(cfg: ModelConfig, params, batch: dict, **fw_kwargs):
    """(loss, gradient tree in the parameters' dtypes) of ``api.lm_loss``.
    Leaves the loss does not reach get zeros, as ``jax.grad`` gives
    them."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = model_api.lm_loss(tree_unflatten(treedef, leaves), cfg,
                                 batch, **fw_kwargs)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def step_loss_and_grads(cfg: ModelConfig, params, batch: dict,
                        num_microbatches: int = 1, **fw_kwargs):
    """(loss, gradients) of one step's ``batch`` (tensors on the params'
    device). With ``num_microbatches`` > 1 the batch splits along its
    leading dim as ``(nm, B / nm)``, the gradients are summed in f32 and
    scaled by ``1 / nm`` and the loss averaged, as the reference's scan."""
    nm = num_microbatches
    if nm == 1:
        return loss_and_grads(cfg, params, batch, **fw_kwargs)
    mbs = {k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])
           for k, v in batch.items()}
    gsum = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32, device=_device(params))
    for i in range(nm):
        l_, g = loss_and_grads(cfg, params, {k: v[i] for k, v in mbs.items()},
                               **fw_kwargs)
        for acc, gi in zip(tree_leaves(gsum), tree_leaves(g)):
            acc.add_(gi)  # f32 += grad, as the reference's f32 sum
        del g
        lsum = lsum + l_
    inv = 1.0 / nm
    for acc in tree_leaves(gsum):
        acc.mul_(inv)
    return lsum * inv, gsum


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, mesh=None, **fw_kwargs):
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as
    device scalars. The update is written into the storage of ``params``
    and ``opt_state``, which are returned (``apply_updates(donate=True)``,
    the counterpart of the reference launcher's donated jit arguments):
    the caller's trees hold the new values after the call."""
    if mesh is not None:  # with or without compress_grads
        raise NotImplementedError(f"a mesh: {_ITEM_14}")

    def train_step(params, opt_state, batch):
        loss, grads = step_loss_and_grads(
            cfg, params, batch_to(batch, _device(params)), num_microbatches,
            **fw_kwargs)
        with torch.no_grad():
            params, opt_state, metrics = apply_updates(
                params, grads, opt_state, opt_cfg, donate=True)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, **fw_kwargs):
    """Returns ``eval_step(params, batch) -> loss``, forward only (no
    autograd), so ``cfg.use_kernels`` may route the norms, the attention
    and the SSD chunk block through the CUDA kernels."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model_api.lm_loss(params, cfg,
                                     batch_to(batch, _device(params)),
                                     **fw_kwargs)

    return eval_step
