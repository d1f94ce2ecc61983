"""Diffusion wrapper: the backbone as a drift f_theta(x, t) — port of
``repro.diffusion.wrapper``.

Latent-sequence denoiser: in-proj latent -> d_model, sinusoidal time
embedding (MLP'd) added to every position, backbone run non-causally, RMS
output norm and out-proj back to the latent dim (velocity prediction under
rectified flow). The time embedding, ``t_mlp*``, the output norm and
``out_proj`` run in f32; the backbone in ``cfg.compute_dtype``.

``make_drift`` returns the port's row drift (``repro_torch.core.ode``):
``drift(x [R, *latent], t [R])`` with latent ``(..., S, L)`` flattens every
row's batch into one ``[rows, S, L]`` backbone call with a per-row time —
one call per CHORDS round for the whole slot x core grid.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api as model_api
from repro_torch.utils.pspec import ParamTree, init_params, spec


def wrapper_specs(cfg: ModelConfig, latent_dim: int) -> dict:
    d = cfg.d_model
    return {
        "backbone": model_api.model_specs(cfg),
        "in_proj": spec((latent_dim, d), (None, "embed")),
        "t_mlp1": spec((256, d), (None, "embed")),
        "t_mlp2": spec((d, d), ("embed", "embed_act")),
        "out_norm": spec((d,), (None,), init="ones"),
        "out_proj": spec((d, latent_dim), ("embed", None), init="zeros"),
    }


def init_wrapper(cfg: ModelConfig, latent_dim: int,
                 generator: torch.Generator = None, dtype=torch.float32,
                 device="cuda") -> ParamTree:
    """Random wrapper parameters as a :class:`ParamTree`.

    The backbone is stored in ``cfg.param_dtype`` (bf16 for
    ``chords-dit-xl``: ~10.9 GB instead of 21.8 GB) and the wrapper head in
    ``dtype`` (f32). The JAX launcher keeps f32 weights and casts them per
    use; casting once at init computes the same numbers, since every use
    casts to the same compute dtype. ``generator`` defaults to seed 0 on
    ``device``.
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    specs = wrapper_specs(cfg, latent_dim)
    backbone = specs.pop("backbone")
    tree = init_params(specs, gen, dtype, dev)
    tree["backbone"] = init_params(backbone, gen,
                                   getattr(torch, cfg.param_dtype), dev)
    return ParamTree(tree)


def time_embedding(t, dim=256, max_period=1e4):
    """t: scalar or [B] in [0, 1] -> [..., dim] sinusoidal features."""
    t = torch.as_tensor(t, dtype=torch.float32) * 1000.0
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def denoise(params, cfg: ModelConfig, x, t):
    """x: [B, S, latent_dim]; t: scalar or [B] in [0, 1] (per-row times).
    Returns the velocity [B, S, latent_dim] in x's dtype."""
    dt_ = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32
    h = torch.einsum("bsl,ld->bsd", x.to(dt_), params["in_proj"].to(dt_))
    te = time_embedding(torch.as_tensor(t, device=x.device))  # [256]/[B,256]
    te = F.silu(te @ params["t_mlp1"].to(f32))
    te = te @ params["t_mlp2"].to(f32)
    if te.ndim == 2:
        te = te[:, None, :]
    h = h + te.to(dt_)
    h = model_api.forward_hidden(params["backbone"], cfg, h, causal=False)
    hf = h.to(f32)
    hf = hf * torch.rsqrt(torch.mean(hf * hf, -1, keepdim=True)
                          + cfg.norm_eps)
    hf = hf * params["out_norm"].to(f32)
    return torch.einsum("bsd,dl->bsl", hf,
                        params["out_proj"].to(f32)).to(x.dtype)


def make_drift(params, cfg: ModelConfig):
    """Row drift for the port's samplers: x [R, ..., S, L], t [R]."""

    def drift(x, t):
        rows = x.shape[0]
        xf = x.reshape((-1,) + x.shape[-2:])
        per_row = xf.shape[0] // rows
        tf = t.reshape(rows, 1).expand(rows, per_row).reshape(-1)
        return denoise(params, cfg, xf, tf).reshape(x.shape)

    return drift
