"""AdamW with an f32 master copy and an optional error-feedback gradient
compression model — port of ``repro.optim.optimizer``.

State layout mirrors the parameter tree (nested dicts of tensors, leaves in
the JAX package's order, ``utils/tree.py``): ``w32`` (f32 master copy), the
moments ``m`` and ``v``, ``step``, and with ``compress_grads`` the int8
error-feedback residual ``err``. Updates are functional, as in the
reference: each call returns new tensors.

The one-process path is ported. ``grad_shards > 1`` and ``reduced_err``
belong to the wire-compressed collective (ROADMAP.md queue 1 item 14) and
raise. ``jnp.round`` and ``torch.round`` both round half to even, so
:func:`_quantize_ef` quantizes as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

Tree = Any
_ITEM_14 = ("the wire-compressed gradient collective is ROADMAP.md queue 1 "
            "item 14 (dist)")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    compress_grads: bool = False  # error-feedback int8 gradient compression


def lr_at(cfg: AdamWConfig, step):
    """Warmup then cosine decay to ``min_lr_ratio``; ``step`` an int or an
    int tensor (f32 math, as the reference's)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _master_copy(p):
    return p.detach().to(torch.float32, copy=True)


def init_state(params: Tree, cfg: AdamWConfig, grad_shards: int = 1) -> dict:
    """Zero moments, the f32 master copy and step 0 on the params' device."""
    if grad_shards > 1:
        raise NotImplementedError(f"grad_shards={grad_shards}: {_ITEM_14}")

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaf = tree_leaves(params)[0]
    state = {"m": tree_map(f32, params), "v": tree_map(f32, params),
             "w32": tree_map(_master_copy, params),
             "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    if cfg.compress_grads:
        state["err"] = tree_map(f32, params)
    return state


def _global_norm(tree: Tree):
    total = 0
    for x in tree_leaves(tree):  # the reference's Python sum, in leaf order
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total))


def _quantize_ef(g, err):
    """int8 error-feedback quantization (models the compressed all-reduce)."""
    gq = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(gq)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gq / scale), -127, 127)
    deq = q * scale
    return deq, gq - deq


def apply_updates(params: Tree, grads: Tree, state: dict, cfg: AdamWConfig,
                  reduced_err: Tree = None):
    """One AdamW step (f32 math on the master copy). Returns (params in
    each leaf's own dtype, new state, {"grad_norm", "lr"})."""
    if reduced_err is not None:
        raise NotImplementedError(f"reduced_err: {_ITEM_14}")
    step = state["step"]
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * clip, grads)

    leaves, treedef = tree_flatten(grads)
    new_err = None
    if cfg.compress_grads:
        pairs = [_quantize_ef(g, e)
                 for g, e in zip(leaves, tree_leaves(state["err"]))]
        leaves = [p[0] for p in pairs]
        new_err = tree_unflatten(treedef, [p[1] for p in pairs])

    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32) + 1
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(w32, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        w32n = w32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * w32)
        return w32n, m, v

    out = [upd(*a) for a in zip(tree_leaves(state["w32"]), leaves,
                                 tree_leaves(state["m"]),
                                 tree_leaves(state["v"]))]
    w32, m, v = (tree_unflatten(treedef, [o[i] for o in out])
                 for i in range(3))
    new_params = tree_map(lambda w, p: w.to(p.dtype), w32, params)
    new_state = {"m": m, "v": v, "w32": w32, "step": step + 1}
    if cfg.compress_grads:
        new_state["err"] = new_err
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}

