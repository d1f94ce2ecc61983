"""Input specs of every dry-run cell — port of ``repro.launch.specs``.

Each function returns :class:`TensorStruct` leaves (a global shape and a
dtype), never a tensor, so nothing is allocated: the dry run turns them
into fake tensors (``launch/dryrun.py``), laid out on the mesh by their
logical axes. Modality frontends ([audio], [vlm]) are stubs, as in the
reference: the specs provide precomputed frame / patch embeddings instead
of raw media. The optimizer state has no spec table of its own:
:func:`opt_structs` runs ``optim.optimizer.init_state`` on fake
parameters and reads its leaves' shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import api as model_api
from repro_torch.optim.optimizer import AdamWConfig, init_state, state_axes
from repro_torch.utils import pspec


class TensorStruct(NamedTuple):
    """A tensor's global shape and dtype (the counterpart of
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def struct_tree(tree):
    """``tree`` (nested dicts of tensors or ``(shape, dtype)`` pairs) as
    :class:`TensorStruct` leaves."""
    if isinstance(tree, dict):
        return {k: struct_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return TensorStruct(tuple(tree.shape), tree.dtype)
    shape, dtype = tree
    return TensorStruct(tuple(int(d) for d in shape), dtype)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        out = {"tokens": TensorStruct((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = TensorStruct((b, s), i32)
        if model_api.is_encdec(cfg):
            out["src_embeds"] = TensorStruct(
                (b, s // cfg.src_ratio, cfg.d_model), torch.bfloat16)
        return out
    if shape.kind == "decode":
        return {"tokens": TensorStruct((b, 1), i32)}
    raise ValueError(shape.kind)


def batch_axes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind in ("train", "prefill"):
        out = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            out["labels"] = ("batch", "seq")
        if model_api.is_encdec(cfg):
            out["src_embeds"] = ("batch", "seq", "embed_act")
        return out
    return {"tokens": ("batch", None)}


def param_structs(specs, dtype: torch.dtype):
    if isinstance(specs, pspec.ParamSpec):
        return TensorStruct(specs.shape, dtype)
    return {k: param_structs(v, dtype) for k, v in specs.items()}


def model_structs(cfg: ModelConfig):
    """(parameter structs in ``cfg.param_dtype``, their logical axes)."""
    specs = model_api.model_specs(cfg)
    return (param_structs(specs, getattr(torch, cfg.param_dtype)),
            pspec.logical_axes(specs))


def opt_structs(cfg: ModelConfig, opt_cfg: AdamWConfig, grad_shards: int = 1):
    """(optimizer state structs, their logical axes): ``init_state`` on
    fake parameters of ``cfg`` (the error-feedback residual with its [W]
    groups dim when ``grad_shards`` > 1)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ps, axes = model_structs(cfg)

    def fake(t):
        if isinstance(t, dict):
            return {k: fake(v) for k, v in t.items()}
        return torch.empty(t.shape, dtype=t.dtype)

    with FakeTensorMode():
        state = init_state(fake(ps), opt_cfg, grad_shards)
        structs = struct_tree(state)
    return structs, state_axes(axes, opt_cfg, grad_shards)


def cache_structs(cfg: ModelConfig, shape: ShapeConfig):
    """(the decode cache's structs at ``shape``, their logical axes)."""
    mod = model_api.get_module(cfg)
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return struct_tree(mod.cache_specs(cfg, b)), mod.cache_axes(cfg)
    return struct_tree(mod.cache_specs(cfg, b, s)), mod.cache_axes(cfg)


def chords_latent_specs(cfg: ModelConfig, num_cores: int, batch: int,
                        seq: int, latent_dim: int) -> TensorStruct:
    """Latent stack for the CHORDS serve_step dry-run ([K, B, S, L])."""
    return TensorStruct((num_cores, batch, seq, latent_dim), torch.float32)
