"""Parameter specs — port of ``repro.utils.pspec``.

Models declare their parameters as nested dicts of :class:`ParamSpec`
(shape, logical axes, initializer) under the reference's names and stacked
``[L, ...]`` layouts, so that a JAX parameter tree loads into the port as a
plain copy (:func:`repro_torch.utils.convert.load_jax_params`).

:func:`init_params` draws from a ``torch.Generator``. It cannot reproduce
the JAX package's draws (``jax.random.truncated_normal``), so parity tests
always load the reference's parameters instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch import nn

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple  # logical axis name (str|None) per dim
    init: str = "fan_in"  # fan_in | normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank "
                             f"mismatch")


def spec(shape, axes, init: str = "fan_in", scale: float = 1.0) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, scale)


def count_params(specs: Tree) -> int:
    if isinstance(specs, ParamSpec):
        return math.prod(specs.shape)
    return sum(count_params(v) for v in specs.values())


def _trunc_normal(shape, std, gen, device):
    """N(0, std^2) truncated to +-2 std, by inverse-CDF of a uniform draw
    (f32 on ``device``)."""
    lo, hi = (math.erf(-2.0 / math.sqrt(2.0)) + 1) / 2, \
        (math.erf(2.0 / math.sqrt(2.0)) + 1) / 2
    u = torch.rand(shape, generator=gen, device=device)
    u = u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0)
    return u.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std,
                                                              2 * std)


def _init_one(s: ParamSpec, gen, dtype, device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    if s.init in ("normal", "embed"):
        return (s.scale * torch.randn(s.shape, generator=gen,
                                      device=device)).to(dtype)
    if s.init == "fan_in":
        fan_in = max(1, math.prod(s.shape[:-1]))
        return _trunc_normal(s.shape, s.scale / math.sqrt(fan_in), gen,
                             device).to(dtype)
    raise ValueError(f"unknown init {s.init}")


def init_params(specs: Tree, gen: torch.Generator, dtype=torch.float32,
                device="cpu") -> Dict:
    """Materialize a spec tree (sorted-key order, like the reference's tree
    flattening) into a nested dict of tensors. Each leaf is drawn in f32
    and cast to ``dtype`` before the next, so peak memory stays one f32
    leaf above the result."""
    out = {}
    for key in sorted(specs):
        v = specs[key]
        out[key] = (init_params(v, gen, dtype, device) if isinstance(v, dict)
                    else _init_one(v, gen, dtype, device))
    return out


class ParamTree(nn.Module):
    """A nested dict of parameters as an ``nn.Module``: ``tree["blocks"]
    ["attn"]["wq"]`` indexes like the reference's pytree, and
    ``state_dict()`` names are the dotted paths (``blocks.attn.wq``).
    Inference only: the parameters do not require grad."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._names = tuple(sorted(tree))
        for key in self._names:
            v = tree[key]
            if isinstance(v, dict):
                self.add_module(key, ParamTree(v))
            else:
                self.register_parameter(
                    key, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        if key not in self._names:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._names

    def keys(self):
        return self._names
