"""Zamba2 hybrid trunk — port of ``repro.models.zamba2`` (the denoiser
role, ``forward_hidden``; ``prefill``, ``decode_step`` and the caches serve
LM decoding: ROADMAP.md queue 1 item 13).

``num_layers`` Mamba2 (SSD) layers; after every ``attn_every``-th the one
*shared* attention+MLP block (one parameter set, invoked num_layers /
attn_every times) runs on concat(hidden, initial embedding). The JAX
``scan``s over groups and layers are unrolled into loops over layer views of
the stacked ``[L, ...]`` parameters (views, no copies).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.dense import _layer
from repro_torch.utils.pspec import spec


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.attn_every
    assert cfg.num_layers % per == 0, (cfg.num_layers, per)
    return cfg.num_layers // per, per  # (num_groups, layers_per_group)


def specs(cfg: ModelConfig) -> dict:
    n = cfg.num_layers
    d = cfg.d_model
    return {
        "embed": L.embed_specs(cfg),
        "mamba": {
            "ln": spec((n, d), ("layers", None), init="ones"),
            "ssd": M.ssd_specs(cfg, layers=n),
        },
        "shared": {
            "ln_in": spec((2 * d,), (None,), init="ones"),
            "w_in": spec((2 * d, d), ("embed", None)),
            "ln1": spec((d,), (None,), init="ones"),
            "attn": L.attention_specs(cfg),
            "ln2": spec((d,), (None,), init="ones"),
            "mlp": L.mlp_specs(cfg),
            "w_out": spec((d, d), (None, "embed")),
        },
        "final_norm": spec((d,), (None,), init="ones"),
    }


def _shared_block(cfg: ModelConfig, sp, h, h0, positions):
    uk = cfg.use_kernels
    x = torch.cat([h, h0], dim=-1)
    x = L.rmsnorm(x, sp["ln_in"], cfg.norm_eps, use_kernel=uk)
    x = torch.einsum("bse,ed->bsd", x, sp["w_in"].to(h.dtype))
    a_in = L.rmsnorm(x, sp["ln1"], cfg.norm_eps, use_kernel=uk)
    q, k, v = L.qkv_proj(sp["attn"], cfg, a_in, positions)
    attn = L.attend(q, k, v, positions, positions, True, use_kernel=uk)
    x = x + L.out_proj(sp["attn"], attn)
    x = x + L.mlp(sp["mlp"], cfg,
                  L.rmsnorm(x, sp["ln2"], cfg.norm_eps, use_kernel=uk))
    out = torch.einsum("bsd,de->bse", x, sp["w_out"].to(h.dtype))
    return h + out


def forward_hidden(params, cfg: ModelConfig, embeds, positions=None,
                   causal=True):
    """embeds: [B, S, D] -> hidden [B, S, D]. Causal only: ``causal`` is
    accepted for the API's signature and must be True."""
    if not causal:
        raise ValueError("the zamba2 trunk is causal-only (its SSD "
                         "recurrence runs forward in sequence order)")
    b, s, _ = embeds.shape
    g, per = _groups(cfg)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=embeds.device)[None].expand(b, s)
    h0, h = embeds, embeds
    uk = cfg.use_kernels
    for gi in range(g):
        for j in range(per):
            p = _layer(params["mamba"], gi * per + j)
            x = L.rmsnorm(h, p["ln"], cfg.norm_eps, use_kernel=uk)
            y, _ = M.ssd_forward(p["ssd"], cfg, x)
            h = h + y
        h = _shared_block(cfg, params["shared"], h, h0, positions)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps, use_kernel=uk)
