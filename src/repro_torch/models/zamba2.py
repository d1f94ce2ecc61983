"""Zamba2 hybrid — port of ``repro.models.zamba2``: the trunk as a
denoiser (``forward_hidden``) and as an LM (``forward_train``,
``prefill``, ``decode_step`` and the cache).

``num_layers`` Mamba2 (SSD) layers; after every ``attn_every``-th the one
*shared* attention+MLP block (one parameter set, invoked num_layers /
attn_every times) runs on concat(hidden, initial embedding). The JAX
``scan``s over groups and layers are unrolled into loops over layer views of
the stacked ``[L, ...]`` parameters (views, no copies).

``forward_train`` runs the trunk as an LM over whole sequences (no
cache). The LM cache is the reference's: ``conv`` [L, B, W-1, C] (bf16 after the
prefill; a decode step stores it in the dtype the reference's concatenate
promotes it to, f32 for f32 activations), ``ssm`` [L, B, H, hd, N] f32,
``k``/``v`` [G, B, Smax, KV, Dh] bf16, one pair per shared-block
invocation, and ``len`` int32 [B] on the host. A decode step updates it in
place and returns it. Kernel routes follow the reference: the prefill runs
rmsnorm on every norm, flash in the shared block and ``ssd_chunk`` in every
SSD layer; a decode step keeps rmsnorm only in the shared block.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import assign, shard_act, zeros_tree
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.dense import (CACHE_DTYPE, _layers,
                                      _positions, attend_or_decode,
                                      decode_position)
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


def _shared_block(cfg: ModelConfig, sp, h, h0, positions, attn_impl="auto",
                  kv=None, cur=None):
    """The shared attention+MLP block. ``kv``: None (the denoiser), a
    ``(k_g, v_g)`` cache pair that the prefill fills from 0, or, with
    ``cur`` (the host length before this token), the pair a decode step
    writes at ``cur`` and attends over."""
    uk = cfg.use_kernels
    x = torch.cat([h, h0], dim=-1)
    x = L.rmsnorm(x, sp["ln_in"], cfg.norm_eps, use_kernel=uk)
    x = torch.einsum("bse,ed->bsd", x, sp["w_in"].to(h.dtype))
    a_in = L.rmsnorm(x, sp["ln1"], cfg.norm_eps, use_kernel=uk)
    q, k, v = L.qkv_proj(sp["attn"], cfg, a_in, positions)
    attn = attend_or_decode(cfg, q, k, v, positions, True, attn_impl, kv,
                            cur, use_kernel=uk)
    x = x + L.out_proj(sp["attn"], attn)
    x = x + L.mlp(sp["mlp"], cfg,
                  L.rmsnorm(x, sp["ln2"], cfg.norm_eps, use_kernel=uk))
    out = torch.einsum("bsd,de->bse", x, sp["w_out"].to(h.dtype))
    return h + out


def forward_hidden(params, cfg: ModelConfig, embeds, positions=None,
                   causal=True, attn_impl="auto", remat=False, cache=None):
    """embeds: [B, S, D] -> hidden [B, S, D]. Causal only: ``causal`` is
    accepted for the API's signature and must be True. ``cache`` (a new
    cache from :func:`init_cache`, S <= its length) collects every layer's
    conv and SSM state and every shared-block invocation's k/v, as the
    reference's ``collect_kv=True``: conv cast to the cache's bf16, k/v
    written at positions [0, S). ``remat`` recomputes each group (its
    Mamba layers and the shared block) in the backward pass, as the
    reference checkpoints its group body."""
    if not causal:
        raise ValueError("the zamba2 trunk is causal-only (its SSD "
                         "recurrence runs forward in sequence order)")
    b, s, _ = embeds.shape
    g, per = _groups(cfg)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=embeds.device)[None].expand(b, s)
    uk = cfg.use_kernels
    mamba = _layers(params["mamba"])

    def group(h, h0, gi):
        for j in range(per):
            i = gi * per + j
            p = mamba[i]
            x = L.rmsnorm(h, p["ln"], cfg.norm_eps, use_kernel=uk)
            y, (conv, ssm) = M.ssd_forward(p["ssd"], cfg, x)
            if cache is not None:
                assign(cache["conv"], i, conv.to(cache["conv"].dtype))
                assign(cache["ssm"], i, ssm)
            h = h + y
        kv = None if cache is None else (cache["k"][gi], cache["v"][gi])
        return _shared_block(cfg, params["shared"], h, h0, positions,
                             attn_impl, kv)

    h = embeds
    for gi in range(g):
        h = L.remat_call(remat, group, h, embeds, gi)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps, use_kernel=uk)


def forward_train(params, cfg: ModelConfig, tokens, attn_impl="auto",
                  remat=True):
    """tokens: [B, S] -> logits [B, S, V] (S a multiple of the SSD chunk
    or shorter than it)."""
    e = shard_act(L.embed(params["embed"], cfg, tokens),
                  ("batch", "seq", "embed_act"))
    h = forward_hidden(params, cfg, e, attn_impl=attn_impl, remat=remat)
    return L.unembed(params["embed"], cfg, h)


def cache_axes(cfg: ModelConfig):
    ssm_ax = M.ssd_state_axes()
    kv_ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"conv": ssm_ax["conv"], "ssm": ssm_ax["ssm"], "k": kv_ax,
            "v": kv_ax, "len": ("batch",)}


def cache_specs(cfg: ModelConfig, batch, max_len, dtype=CACHE_DTYPE):
    """The cache's leaves as ``(shape, dtype)``."""
    g, _ = _groups(cfg)
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    ssm = M.ssd_state_specs(cfg, batch, cfg.num_layers)
    shape = (g, batch, max_len, kv, dh)
    return {"conv": ssm["conv"], "ssm": ssm["ssm"], "k": (shape, dtype),
            "v": (shape, dtype), "len": ((batch,), torch.int32)}


def init_cache(cfg: ModelConfig, batch, max_len, dtype=CACHE_DTYPE,
               device="cuda"):
    """An empty cache: zeros on ``device`` (under a mesh context each
    rank's block), ``len`` zeros on the host."""
    return zeros_tree(cache_specs(cfg, batch, max_len, dtype),
                      cache_axes(cfg), resolve_device(device), skip=("len",))


def prefill(params, cfg: ModelConfig, tokens, max_len, attn_impl="auto"):
    """tokens: [B, S] -> (logits [B, S, V], cache filled to S). The final
    norm takes the kernel route here: the reference's prefill runs
    ``forward_hidden``."""
    b, s = tokens.shape
    e = L.embed(params["embed"], cfg, tokens)
    cache = init_cache(cfg, b, max_len, device=e.device)
    h = forward_hidden(params, cfg, e, attn_impl=attn_impl, cache=cache)
    cache["len"].fill_(s)
    return L.unembed(params["embed"], cfg, h), cache


def _store(cache, key, i, value):
    """Layer ``i`` of ``cache[key]`` := value, in place. When ``value``'s
    dtype differs (the conv state promoted to f32) the leaf is first cast
    to it, as the reference's stacked step outputs carry it."""
    if cache[key].dtype != value.dtype:
        cache[key] = cache[key].to(value.dtype)
    assign(cache[key], i, value)


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_impl="auto"):
    """tokens: [B, 1]; returns (logits [B, 1, V], cache), the cache updated
    in place. The Mamba norms and the final norm stay plain, as in the
    reference."""
    cur = decode_position(cache)
    b = tokens.shape[0]
    g, per = _groups(cfg)
    positions = _positions(cfg, b, 1, offset=cur, device=tokens.device)
    h0 = h = L.embed(params["embed"], cfg, tokens)
    mamba = _layers(params["mamba"])
    for gi in range(g):
        for j in range(per):
            i = gi * per + j
            p = mamba[i]
            x = L.rmsnorm(h, p["ln"], cfg.norm_eps)
            y, (conv, ssm) = M.ssd_decode_step(p["ssd"], cfg, x,
                                               cache["conv"][i],
                                               cache["ssm"][i])
            _store(cache, "conv", i, conv)
            _store(cache, "ssm", i, ssm)
            h = h + y
        h = _shared_block(cfg, params["shared"], h, h0, positions,
                          attn_impl, (cache["k"][gi], cache["v"][gi]), cur)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    cache["len"] += 1
    return L.unembed(params["embed"], cfg, h), cache
