"""Dense decoder-only transformer — port of ``repro.models.dense``
(qwen1.5-*, gemma-7b, internlm2, qwen2-vl, the DiT trunk).

Three entry points share one layer body:

  * ``forward_hidden`` — embeds in, hidden out (the denoiser role;
                         optionally non-causal)
  * ``prefill``        — tokens -> logits + KV cache
  * ``decode_step``    — one token + cache -> logits + cache

Parameters keep the reference's stacked ``[L, ...]`` layout; the layer loop
slices layer ``l`` out of each stacked tensor (a view, no copy). The KV
cache is the reference's ``{"k", "v", "len"}``: k/v ``[L, B, Smax, KV,
Dh]`` in bf16 whatever the compute dtype, written in place (the
counterpart of the reference's donated carry), and ``len`` int32 ``[B]``
kept on the host, so a decode step knows its write position and the
cache's live prefix without waiting for the device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.utils.pspec import spec

CACHE_DTYPE = torch.bfloat16


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


def attend_or_decode(cfg: ModelConfig, q, k, v, positions, causal, attn_impl,
                     cache=None, cur=None, use_kernel=False):
    """The attention of a block, shared with ``moe``. Prefill and the
    denoiser (``cache`` None or a ``(k_l, v_l)`` pair to fill from 0):
    attention over this call's k/v. Decode (``cur``, the host length
    before this token, uniform over the batch as in the reference): k/v
    written in place at ``cur``, then one query against the cache."""
    if cur is not None:
        k_cache, v_cache = cache
        k_cache[:, cur:cur + 1] = k.to(k_cache.dtype)
        v_cache[:, cur:cur + 1] = v.to(v_cache.dtype)
        return L.attend_decode(q, k_cache, v_cache, cur + 1)
    q_pos = positions[0] if cfg.mrope_sections else positions
    attn = L.attend(q, k, v, q_pos, q_pos, causal, impl=attn_impl,
                    use_kernel=use_kernel)
    if cache is not None:
        s = k.shape[1]
        cache[0][:, :s] = k.to(cache[0].dtype)
        cache[1][:, :s] = v.to(cache[1].dtype)
    return attn


def _block(cfg: ModelConfig, p, h, positions, causal, attn_impl="auto",
           cache=None, cur=None):
    """One transformer block. ``cfg.use_kernels`` routes the norms and the
    (non-decode) attention through the CUDA kernels; positions here are
    0-based aranges, which is the flash kernel's causal contract."""
    uk = cfg.use_kernels
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps, use_kernel=uk)
    q, k, v = L.qkv_proj(p["attn"], cfg, x, positions)
    attn = attend_or_decode(cfg, q, k, v, positions, causal, attn_impl,
                            cache, cur, use_kernel=uk)
    h = h + L.out_proj(p["attn"], attn)
    x = L.rmsnorm(h, p["ln2"], cfg.norm_eps, use_kernel=uk)
    return h + L.mlp(p["mlp"], cfg, x)


def _positions(cfg: ModelConfig, b, s, offset=0, device="cpu"):
    pos = (torch.arange(s, dtype=torch.int32, device=device)[None, :]
           + offset).expand(b, s)
    if cfg.mrope_sections:
        return pos[None].expand(3, b, s)  # all-text M-RoPE
    return pos


def forward_hidden(params, cfg: ModelConfig, embeds, positions=None,
                   causal=False, attn_impl="auto"):
    """embeds: [B, S, D] -> hidden [B, S, D]."""
    b, s, _ = embeds.shape
    if positions is None:
        positions = _positions(cfg, b, s, device=embeds.device)
    h = embeds
    for i in range(cfg.num_layers):
        h = _block(cfg, _layer(params["blocks"], i), h, positions, causal,
                   attn_impl)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps,
                     use_kernel=cfg.use_kernels)


def cache_specs(cfg: ModelConfig, batch, max_len, dtype=CACHE_DTYPE):
    """The cache's leaves as ``(shape, dtype)``."""
    kv, dh, n = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    shape = (n, batch, max_len, kv, dh)
    return {"k": (shape, dtype), "v": (shape, dtype),
            "len": ((batch,), torch.int32)}


def init_cache(cfg: ModelConfig, batch, max_len, dtype=CACHE_DTYPE,
               device="cuda"):
    """An empty cache: k/v zeros on ``device``, ``len`` zeros on the
    host."""
    dev = resolve_device(device)
    sp = cache_specs(cfg, batch, max_len, dtype)
    return {"k": torch.zeros(*sp["k"][0], dtype=dtype, device=dev),
            "v": torch.zeros(*sp["v"][0], dtype=dtype, device=dev),
            "len": torch.zeros(batch, dtype=torch.int32)}


def run_prefill(params, cfg: ModelConfig, e, block, max_len):
    """The prefill loop of ``dense`` and ``moe``: ``block(p, h, positions,
    kv)`` per layer over embeddings ``e`` [B, S, D], filling a new cache
    to S; the final norm stays plain, as in the reference."""
    b, s = e.shape[:2]
    positions = _positions(cfg, b, s, device=e.device)
    cache = init_cache(cfg, b, max_len, device=e.device)
    h = e
    for i in range(cfg.num_layers):
        h = block(_layer(params["blocks"], i), h, positions,
                  (cache["k"][i], cache["v"][i]))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    cache["len"].fill_(s)
    return L.unembed(params["embed"], cfg, h), cache


def run_decode(params, cfg: ModelConfig, tokens, cache, block):
    """One decode step of ``dense`` and ``moe`` (``block(p, h, positions,
    kv, cur)`` per layer): the token at position ``len[0]`` for the whole
    batch, as in the reference; the cache is updated in place and
    returned."""
    lens = cache["len"].tolist()
    cur = lens[0]
    if any(n != cur for n in lens):
        raise ValueError(f"decode_step: the batch's cache lengths differ "
                         f"({lens}); the reference writes one position "
                         f"for the whole batch")
    if cur >= cache["k"].shape[2]:
        raise ValueError(f"decode_step: the cache is full ({cur} of "
                         f"{cache['k'].shape[2]} positions)")
    b = tokens.shape[0]
    positions = _positions(cfg, b, 1, offset=cur, device=tokens.device)
    h = L.embed(params["embed"], cfg, tokens)
    for i in range(cfg.num_layers):
        h = block(_layer(params["blocks"], i), h, positions,
                  (cache["k"][i], cache["v"][i]), cur)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    cache["len"] += 1
    return L.unembed(params["embed"], cfg, h), cache


def prefill(params, cfg: ModelConfig, tokens, max_len, attn_impl="auto",
            embeds=None):
    """tokens: [B, S] -> (logits [B, S, V], cache filled to S). ``embeds``
    [B, S, D] replaces the token embeddings (the VLM's patch
    embeddings)."""
    e = embeds if embeds is not None else \
        L.embed(params["embed"], cfg, tokens)

    def block(p, h, positions, kv):
        return _block(cfg, p, h, positions, True, attn_impl, cache=kv)

    return run_prefill(params, cfg, e, block, max_len)


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_impl="auto"):
    """tokens: [B, 1]; returns (logits [B, 1, V], cache)."""
    def block(p, h, positions, kv, cur):
        return _block(cfg, p, h, positions, True, attn_impl, cache=kv,
                      cur=cur)

    return run_decode(params, cfg, tokens, cache, block)
