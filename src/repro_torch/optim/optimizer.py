"""AdamW with an f32 master copy and an optional error-feedback gradient
compression model — port of ``repro.optim.optimizer``.

State layout mirrors the parameter tree (nested dicts of tensors, leaves in
the JAX package's order, ``utils/tree.py``): ``w32`` (f32 master copy), the
moments ``m`` and ``v``, ``step``, and with ``compress_grads`` the int8
error-feedback residual ``err``. Updates are functional, as in the
reference: each call returns new tensors.

On a mesh the leaves are DTensors: the state is made like the parameters
(same placements; ``err`` with ``grad_shards`` > 1 takes a leading [W]
"groups" dim on the mesh's ``data`` axis, one residual a data rank, for the
wire-compressed step of ``train/train_step.py``), each gradient is first
laid out as its parameter, and the global norm is one reduction over the
mesh. ``jnp.round`` and ``torch.round`` both round half to even, so
:func:`_quantize_ef` quantizes as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)

Tree = Any


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


def _zeros_f32(p):
    """f32 zeros laid out as ``p`` (a DTensor keeps its placements)."""
    return torch.zeros_like(p, dtype=torch.float32)


def _group_err(p, grad_shards: int):
    """The [W, *p.shape] f32 zero residual of the compressed step: the
    leading "groups" dim on the mesh's ``data`` axis, the rest laid out as
    ``p`` on the other mesh axes (``state_axes``'s ``("groups",) + axes``
    under ``TRAIN_RULES``)."""
    shape = (grad_shards,) + tuple(p.shape)
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dt_zeros

    mesh = p.device_mesh
    lay = []
    for name, pl in zip(mesh.mesh_dim_names, p.placements):
        if name == "data":
            lay.append(Shard(0))
        elif isinstance(pl, Shard):
            lay.append(Shard(pl.dim + 1))
        else:
            lay.append(Replicate())
    return dt_zeros(shape, dtype=torch.float32, device_mesh=mesh,
                    placements=lay)


def init_state(params: Tree, cfg: AdamWConfig, grad_shards: int = 1) -> dict:
    """Zero moments, the f32 master copy and step 0 on the params' device,
    each leaf laid out as its parameter. ``grad_shards`` > 1 gives the
    error-feedback residual a leading [W] dim: one residual a data rank,
    for the wire-compressed step where each rank quantizes its own group's
    gradient."""
    leaf = tree_leaves(params)[0]
    state = {"m": tree_map(_zeros_f32, params),
             "v": tree_map(_zeros_f32, params),
             "w32": tree_map(_master_copy, params),
             "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}
    if cfg.compress_grads:
        state["err"] = tree_map(
            (lambda p: _group_err(p, grad_shards)) if grad_shards > 1
            else _zeros_f32, params)
    return state


def state_axes(param_axes: Tree, cfg: AdamWConfig,
               grad_shards: int = 1) -> dict:
    """The state's logical axes from the parameters' (a tree of tuples)."""
    def ident(t):
        return t if isinstance(t, tuple) else {k: ident(v)
                                               for k, v in t.items()}

    def groups(t):
        return ("groups",) + t if isinstance(t, tuple) else \
            {k: groups(v) for k, v in t.items()}

    s = {"m": ident(param_axes), "v": ident(param_axes),
         "w32": ident(param_axes), "step": ()}
    if cfg.compress_grads:
        s["err"] = groups(param_axes) if grad_shards > 1 else s["m"]
    return s


def _global_norm(tree: Tree):
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        return _global_norm_mesh(leaves)
    total = 0
    for x in leaves:  # the reference's Python sum, in leaf order
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total))


def _global_norm_mesh(leaves):
    """The global norm of DTensor leaves (each laid out as its parameter:
    sharded or replicated, never partial) with one reduction over the
    mesh: every rank sums the squares of its own blocks, a block that is
    replicated along a mesh dim counted only at coordinate 0 there, and the
    per-rank sums are reduced once as a partial DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = 0
    for x in leaves:
        sq = torch.sum(torch.square(x.to_local().to(torch.float32)))
        if any(isinstance(pl, Replicate) and c != 0
               for pl, c in zip(x.placements, coord)):
            sq = sq * 0.0
        total = total + sq
    part = DTensor.from_local(torch.as_tensor(total), mesh,
                              [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(part.full_tensor())


def _quantize_ef(g, err):
    """int8 error-feedback quantization (models the compressed all-reduce)."""
    gq = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(gq)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gq / scale), -127, 127)
    deq = q * scale
    return deq, gq - deq


def apply_updates(params: Tree, grads: Tree, state: dict, cfg: AdamWConfig,
                  reduced_err: Tree = None, donate: bool = False):
    """One AdamW step (f32 math on the master copy). Returns (params in
    each leaf's own dtype, new state, {"grad_norm", "lr"}).

    ``donate`` is the counterpart of the reference's donated jit
    arguments: the same values, written leaf by leaf into the storage of
    ``params`` and of ``state``'s ``w32``/``m``/``v`` (and ``err``), which
    are returned (``state`` updated in place). Either way one leaf is
    updated at a time; donated, only that leaf's temporaries are alive
    beside the state, where the functional form holds the old and the new
    state together.

    ``reduced_err``: the residual tree of the wire-compressed gradient
    collective (``train_step._make_compressed_step``). The grads are then
    already int8-reduced on the wire, so the local quantization model is
    skipped and that residual is carried as the new ``err``.

    DTensor leaves (a mesh): each gradient is first laid out as its
    parameter (a partial gradient is reduced here)."""
    if tree_leaves(params) and is_dtensor(tree_leaves(params)[0]):
        grads = tree_map(lambda p, g: g.redistribute(p.device_mesh,
                                                     p.placements),
                         params, grads)
    step = state["step"]
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
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

    names = ("w32", "m", "v") + (("err",) if cfg.compress_grads else ())
    old = [tree_leaves(state[n]) for n in names]
    p_leaves, treedef = tree_flatten(params)
    red_err = None if reduced_err is None else tree_leaves(reduced_err)
    new = [[] for _ in names]
    new_p = []

    def update_leaf(i, p, g):
        # a function, so that the leaf's temporaries are freed on return,
        # before the next leaf's are made
        g = g.to(torch.float32) * clip
        err = ()
        if cfg.compress_grads and reduced_err is not None:
            err = (red_err[i],)
        elif cfg.compress_grads:
            g, e = _quantize_ef(g, old[3][i])
            err = (e,)
        vals = upd(old[0][i], g, old[1][i], old[2][i]) + err
        for n, val in enumerate(vals):
            new[n].append(old[n][i].copy_(val) if donate else val)
        new_p.append(p.copy_(new[0][i]) if donate else new[0][i].to(p.dtype))

    for i, (p, g) in enumerate(zip(p_leaves, tree_leaves(grads))):
        update_leaf(i, p, g)

    metrics = {"grad_norm": gnorm, "lr": lr}
    if donate:
        state["step"] = step + 1
        return params, state, metrics
    new_state = {n: tree_unflatten(treedef, leaves)
                 for n, leaves in zip(names, new)}
    new_state["step"] = step + 1
    return tree_unflatten(treedef, new_p), new_state, metrics
