"""Model API by config family — port of ``repro.models.api``: the dense
trunk (``dense``, and the VLM, which runs on it), ``moe``, and the zamba2
hybrid as a denoiser trunk.

Families still to port raise ``NotImplementedError`` naming their
ROADMAP.md item: xLSTM (``ssm``), enc-dec (``encdec``, ``audio``), and the
hybrid's LM mode (``prefill``, ``decode_step``, its cache), all queue 1
item 13.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import dense, moe, zamba2
from repro_torch.utils import pspec

_FAMILY = {"dense": dense, "vlm": dense, "moe": moe, "hybrid": zamba2}
_NOT_PORTED = {
    "ssm": "xLSTM is not ported yet: ROADMAP.md queue 1 item 13",
    "encdec": "enc-dec is not ported yet: ROADMAP.md queue 1 item 13",
    "audio": "enc-dec is not ported yet: ROADMAP.md queue 1 item 13",
}
_LM_NOT_PORTED = {
    "hybrid": "the hybrid's LM mode (zamba2 prefill, decode_step, "
              "cache_specs/init_cache) is not ported yet: ROADMAP.md queue "
              "1 item 13",
}


def get_module(cfg: ModelConfig):
    if cfg.family in _FAMILY:
        return _FAMILY[cfg.family]
    raise NotImplementedError(
        f"model family {cfg.family!r}: "
        f"{_NOT_PORTED.get(cfg.family, 'no such family')}")


def lm_module(cfg: ModelConfig):
    """The family module's LM entry points (``prefill``, ``decode_step``,
    ``init_cache``); raises for a family whose LM mode is not ported."""
    if cfg.family in _LM_NOT_PORTED:
        raise NotImplementedError(_LM_NOT_PORTED[cfg.family])
    return get_module(cfg)


def model_specs(cfg: ModelConfig) -> dict:
    return get_module(cfg).specs(cfg)


def param_count(cfg: ModelConfig) -> int:
    return pspec.count_params(model_specs(cfg))


def init_model(cfg: ModelConfig, seed_or_generator=0, device="cuda",
               dtype=None) -> pspec.ParamTree:
    """Random parameters as a :class:`~repro_torch.utils.pspec.ParamTree`
    in ``dtype`` (default ``cfg.param_dtype``), drawn on ``device`` from a
    ``torch.Generator`` or a seed. The draws are not the JAX package's:
    parity tests load its parameters (``load_jax_params``)."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return pspec.ParamTree(pspec.init_params(model_specs(cfg), gen, dtype,
                                             dev))


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family in ("encdec", "audio")


def forward_hidden(params, cfg: ModelConfig, embeds, **kw):
    """Backbone as a denoiser trunk: embeds in, hidden out (non-causal for
    the dense trunk). The hybrid's recurrence is causal-only, so, as in the
    reference, it runs causally whatever ``causal`` the caller passes."""
    if cfg.family == "hybrid":
        kw["causal"] = True
    return get_module(cfg).forward_hidden(params, cfg, embeds, **kw)
