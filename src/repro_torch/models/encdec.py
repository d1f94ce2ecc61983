"""SeamlessM4T-medium enc-dec — port of ``repro.models.encdec`` (audio
frontend stubbed).

Encoder: ``enc_layers`` bidirectional layers over precomputed frame
embeddings ([B, S_src, D]). Decoder: ``dec_layers`` causal layers with
cross-attention into the encoder memory. No kernel route, as in the
reference (``api.forward_hidden``'s final norm aside).

The cache is the reference's: self-attention ``k``/``v`` [Ld, B, Smax, KV,
Dh] and cross-attention ``ck``/``cv`` [Ld, B, S_src, KV, Dh], all bf16,
and ``len`` int32 [B] on the host. A decode step writes k/v in place at
``len`` and returns the cache. Its cross-attention reads the bf16 ``ck``/
``cv`` against an f32 query at the f32 configs: the plain attention
upcasts both sides to f32 before its products, as ``jnp.einsum`` promotes.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import assign, shard_act, zeros_tree
from repro_torch.models import layers as L
from repro_torch.models.dense import (CACHE_DTYPE, _layers,
                                      _positions, attend_or_decode,
                                      decode_position)
from repro_torch.utils.pspec import spec


def specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    ne, nd = cfg.enc_layers, cfg.dec_layers
    return {
        "embed": L.embed_specs(cfg),
        "enc": {
            "ln1": spec((ne, d), ("layers", None), init="ones"),
            "attn": L.attention_specs(cfg, layers=ne),
            "ln2": spec((ne, d), ("layers", None), init="ones"),
            "mlp": L.mlp_specs(cfg, layers=ne),
        },
        "enc_norm": spec((d,), (None,), init="ones"),
        "dec": {
            "ln1": spec((nd, d), ("layers", None), init="ones"),
            "self_attn": L.attention_specs(cfg, layers=nd),
            "ln_x": spec((nd, d), ("layers", None), init="ones"),
            "cross_attn": L.attention_specs(cfg, layers=nd),
            "ln2": spec((nd, d), ("layers", None), init="ones"),
            "mlp": L.mlp_specs(cfg, layers=nd),
        },
        "final_norm": spec((d,), (None,), init="ones"),
    }


def encode(params, cfg: ModelConfig, src_embeds, attn_impl="auto",
           remat=False):
    """src_embeds: [B, S_src, D] (stub frontend output) -> memory
    [B, S_src, D]. ``remat`` recomputes each layer in the backward
    pass."""
    b, s, _ = src_embeds.shape
    pos = _positions(cfg, b, s, device=src_embeds.device)

    def body(h, p):
        x = L.rmsnorm(h, p["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_proj(p["attn"], cfg, x, pos)
        h = h + L.out_proj(p["attn"], L.attend(q, k, v, pos, pos, False,
                                               impl=attn_impl))
        h = h + L.mlp(p["mlp"], cfg, L.rmsnorm(h, p["ln2"], cfg.norm_eps))
        return shard_act(h, ("batch", "seq", "embed_act"))

    h = src_embeds
    for p in _layers(params["enc"]):
        h = L.remat_call(remat, body, h, p)
    return L.rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _cross_kv(p, memory, dtype):
    """The cross-attention k/v of one decoder layer from the memory."""
    ck = torch.einsum("bsd,dhk->bshk", memory, p["wk"].to(dtype))
    cv = torch.einsum("bsd,dhk->bshk", memory, p["wv"].to(dtype))
    if "bk" in p:
        ck = ck + p["bk"].to(dtype)
        cv = cv + p["bv"].to(dtype)
    return ck, cv


def _dec_block(cfg, p, h, memory, pos, mem_pos, attn_impl, self_cache=None,
               cross_kv=None, cur=None):
    """One decoder block. ``self_cache``: None, a ``(k_l, v_l)`` pair the
    prefill fills from 0, or with ``cur`` (the host length before this
    token) the pair a decode step writes at ``cur`` and attends over.
    ``cross_kv`` (k, v) replaces the projection of ``memory``."""
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["self_attn"], cfg, x, pos)
    attn = attend_or_decode(cfg, q, k, v, pos, True, attn_impl, self_cache,
                            cur)
    h = h + L.out_proj(p["self_attn"], attn)
    # cross attention (non-causal over memory)
    x = L.rmsnorm(h, p["ln_x"], cfg.norm_eps)
    if cross_kv is not None:
        ck, cv = cross_kv
        qx = torch.einsum("bsd,dhk->bshk", x,
                          p["cross_attn"]["wq"].to(x.dtype))
        if "bq" in p["cross_attn"]:
            qx = qx + p["cross_attn"]["bq"].to(x.dtype)
    else:
        qx, ck, cv = L.qkv_proj(p["cross_attn"], cfg, x, None,
                                cross_kv=memory)
    ax = L.attend(qx, ck, cv, pos, mem_pos, False, impl=attn_impl)
    h = h + L.out_proj(p["cross_attn"], ax)
    h = h + L.mlp(p["mlp"], cfg, L.rmsnorm(h, p["ln2"], cfg.norm_eps))
    return shard_act(h, ("batch", "seq", "embed_act"))


def forward_train(params, cfg: ModelConfig, tokens, src_embeds,
                  attn_impl="auto", remat=True):
    """Seq2seq: encode ``src_embeds`` [B, S_src, D], decode ``tokens``
    [B, S] with cross-attention into the memory; returns logits
    [B, S, V]. The memory keeps the source frames' dtype, as in the
    reference: f32 frames (the data pipeline's) run the encoder in f32,
    and the decoder's cross-attention k/v promote to it
    (:func:`L.qkv_proj`)."""
    memory = encode(params, cfg, src_embeds, attn_impl, remat)
    b, s = tokens.shape
    pos = _positions(cfg, b, s, device=tokens.device)
    mem_pos = _positions(cfg, b, memory.shape[1], device=tokens.device)

    def body(h, p):
        return _dec_block(cfg, p, h, memory, pos, mem_pos, attn_impl)

    h = shard_act(L.embed(params["embed"], cfg, tokens),
                  ("batch", "seq", "embed_act"))
    for p in _layers(params["dec"]):
        h = L.remat_call(remat, body, h, p)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h)


def cache_axes(cfg: ModelConfig):
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "ck": ax, "cv": ax, "len": ("batch",)}


def cache_specs(cfg: ModelConfig, batch, max_len, dtype=CACHE_DTYPE,
                src_len=None):
    """The cache's leaves as ``(shape, dtype)``; ``src_len`` defaults to
    ``max_len // src_ratio``."""
    kv, dh, nd = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.dec_layers
    src_len = src_len if src_len is not None else max_len // cfg.src_ratio
    self_shape = (nd, batch, max_len, kv, dh)
    cross_shape = (nd, batch, src_len, kv, dh)
    return {"k": (self_shape, dtype), "v": (self_shape, dtype),
            "ck": (cross_shape, dtype), "cv": (cross_shape, dtype),
            "len": ((batch,), torch.int32)}


def init_cache(cfg: ModelConfig, batch, max_len, dtype=CACHE_DTYPE,
               src_len=None, device="cuda"):
    """An empty cache: zeros on ``device`` (under a mesh context each
    rank's block), ``len`` zeros on the host."""
    return zeros_tree(cache_specs(cfg, batch, max_len, dtype, src_len),
                      cache_axes(cfg), resolve_device(device), skip=("len",))


def prefill(params, cfg: ModelConfig, tokens, max_len, src_embeds,
            attn_impl="auto"):
    """Encode + decoder prefill: tokens [B, S], src_embeds [B, S_src, D] ->
    (logits [B, S, V], cache with self k/v filled to S and cross k/v)."""
    memory = encode(params, cfg, src_embeds, attn_impl)
    b, s = tokens.shape
    pos = _positions(cfg, b, s, device=tokens.device)
    mem_pos = _positions(cfg, b, memory.shape[1], device=tokens.device)
    h = L.embed(params["embed"], cfg, tokens)
    cache = init_cache(cfg, b, max_len, src_len=memory.shape[1],
                       device=h.device)
    for i, p in enumerate(_layers(params["dec"])):
        ck, cv = _cross_kv(p["cross_attn"], memory, h.dtype)
        h = _dec_block(cfg, p, h, memory, pos, mem_pos, attn_impl,
                       self_cache=(cache["k"][i], cache["v"][i]),
                       cross_kv=(ck, cv))
        assign(cache["ck"], i, ck.to(cache["ck"].dtype))
        assign(cache["cv"], i, cv.to(cache["cv"].dtype))
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    cache["len"].fill_(s)
    return L.unembed(params["embed"], cfg, h), cache


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_impl="auto"):
    """tokens: [B, 1]; returns (logits [B, 1, V], cache), the cache updated
    in place."""
    cur = decode_position(cache)
    b = tokens.shape[0]
    pos = _positions(cfg, b, 1, offset=cur, device=tokens.device)
    mem_pos = _positions(cfg, b, cache["ck"].shape[2], device=tokens.device)
    h = L.embed(params["embed"], cfg, tokens)
    for i, p in enumerate(_layers(params["dec"])):
        h = _dec_block(cfg, p, h, None, pos, mem_pos, attn_impl,
                       self_cache=(cache["k"][i], cache["v"][i]),
                       cross_kv=(cache["ck"][i], cache["cv"][i]), cur=cur)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    cache["len"] += 1
    return L.unembed(params["embed"], cfg, h), cache
