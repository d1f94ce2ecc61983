"""Dense transformer trunk — port of ``repro.models.dense`` (the
denoiser role, ``forward_hidden``; LM prefill/decode come with the LM
families, ROADMAP.md queue 1 item 13).

Parameters keep the reference's stacked ``[L, ...]`` layout; the layer loop
slices layer ``l`` out of each stacked tensor (a view, no copy).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.pspec import spec


def specs(cfg: ModelConfig) -> dict:
    n = cfg.num_layers
    return {
        "embed": L.embed_specs(cfg),
        "blocks": {
            "ln1": spec((n, cfg.d_model), ("layers", None), init="ones"),
            "attn": L.attention_specs(cfg, layers=n),
            "ln2": spec((n, cfg.d_model), ("layers", None), init="ones"),
            "mlp": L.mlp_specs(cfg, layers=n),
        },
        "final_norm": spec((cfg.d_model,), (None,), init="ones"),
    }


def _layer(blocks, i: int) -> dict:
    """Layer ``i`` of the stacked block parameters as a nested dict."""
    return {k: blocks[k][i] if isinstance(blocks[k], torch.Tensor)
            else _layer(blocks[k], i) for k in blocks.keys()}


def _block(cfg: ModelConfig, p, h, positions, causal):
    uk = cfg.use_kernels
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps, use_kernel=uk)
    q, k, v = L.qkv_proj(p["attn"], cfg, x, positions)
    attn = L.attend(q, k, v, positions, positions, causal, use_kernel=uk)
    h = h + L.out_proj(p["attn"], attn)
    x = L.rmsnorm(h, p["ln2"], cfg.norm_eps, use_kernel=uk)
    return h + L.mlp(p["mlp"], cfg, x)


def forward_hidden(params, cfg: ModelConfig, embeds, positions=None,
                   causal=False):
    """embeds: [B, S, D] -> hidden [B, S, D]."""
    b, s, _ = embeds.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=embeds.device)[None].expand(b, s)
    h = embeds
    for i in range(cfg.num_layers):
        h = _block(cfg, _layer(params["blocks"], i), h, positions, causal)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps,
                     use_kernel=cfg.use_kernels)
