"""Transformer layers — port of ``repro.models.layers`` (what the dense
denoiser uses): RMSNorm, RoPE, QKV/out projections, GQA attention, the
gated MLP.

``use_kernel=True`` routes RMSNorm and attention through
``repro_torch.kernels``: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. The plain path here is op for op those plain
versions, so on the CPU the flag never changes a bit. One deliberate
difference from the reference: :func:`attend_full` scales q before the QK
product (as the flash kernel and its oracle do) where ``repro``'s
``attend_full`` scales the logits after it — that keeps the CPU flip
bitwise and reassociates one f32 multiply against the JAX package (within
the 2e-5 f32 attention contract).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import masked_attention
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.utils.pspec import spec


def rmsnorm(x, w, eps=1e-6, use_kernel=False):
    """RMSNorm; ``use_kernel`` dispatches to the CUDA kernel on the card."""
    return rmsnorm_ops.rmsnorm(x, w, eps, use_kernel=use_kernel)


def rope_freqs(head_dim: int, theta: float, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """Split-half RoPE. x: [B, S, H, Dh]; positions: [B, S] int."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_specs(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    d, h, kv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)

    def s(shape, axes, **kw):
        return spec(lead + tuple(shape), lax_ + tuple(axes), **kw)

    specs = {
        "wq": s((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": s((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": s((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": s((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = s((h, dh), ("heads", "head_dim"), init="zeros")
        specs["bk"] = s((kv, dh), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = s((kv, dh), ("kv_heads", "head_dim"), init="zeros")
    return specs


def qkv_proj(p, cfg: ModelConfig, x, positions, theta=None):
    """x: [B, S, D] -> q [B, S, H, Dh], k/v [B, S, KV, Dh] (RoPE applied)."""
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet: ROADMAP.md "
                                  "queue 1 item 13 (LM families)")
    theta = cfg.rope_theta if theta is None else theta
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def out_proj(p, attn_out):
    """attn_out: [B, S, H, Dh] -> [B, S, D]."""
    return torch.einsum("bshk,hkd->bsd", attn_out,
                        p["wo"].to(attn_out.dtype))


def attend_full(q, k, v, q_pos, k_pos, causal: bool,
                scale: Optional[float] = None):
    """Materialized GQA attention. q: [B,Sq,H,Dh], k/v: [B,Sk,KV,Dh]."""
    mask = None
    if causal:
        mask = q_pos[:, None, None, :, None] >= k_pos[:, None, None, None, :]
    return masked_attention(q, k, v, mask, scale)


def attend(q, k, v, q_pos, k_pos, causal: bool,
           scale: Optional[float] = None, use_kernel=False):
    """GQA attention; ``use_kernel`` dispatches to the flash kernel on the
    card. The kernel derives the causal mask from 0-based positions — what
    ``forward_hidden`` passes — and masks Sq/Sk tails itself, so unlike the
    reference no shape falls back to another path."""
    if use_kernel:
        return flash_ops.attend(q, k, v, causal=causal, scale=scale)
    return attend_full(q, k, v, q_pos, k_pos, causal, scale)


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None,
              layers: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)

    def s(shape, axes):
        return spec(lead + tuple(shape), lax_ + tuple(axes))

    return {
        "w_gate": s((d, f), ("embed", "ffn")),
        "w_up": s((d, f), ("embed", "ffn")),
        "w_down": s((f, d), ("ffn", "embed")),
    }


def mlp(p, cfg: ModelConfig, x):
    if cfg.act == "geglu":
        def act(t):
            return F.gelu(t, approximate="tanh")
    else:
        act = F.silu
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    return torch.einsum("bsf,fd->bsd", act(g) * u, p["w_down"].to(x.dtype))


def embed_specs(cfg: ModelConfig):
    specs = {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         init="embed", scale=1.0 / math.sqrt(cfg.d_model))}
    if not cfg.tie_embeddings:
        specs["unembed"] = spec((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))
    return specs
