"""Transformer layers — port of ``repro.models.layers``: RMSNorm, RoPE and
M-RoPE, QKV/out projections, GQA attention (materialized, chunked online
softmax, one query against a KV cache), the gated MLP, embedding and
unembedding.

``use_kernel=True`` routes RMSNorm and attention through
``repro_torch.kernels``: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. The plain path here is op for op those plain
versions, so on the CPU the flag never changes a bit. One deliberate
difference from the reference: :func:`attend_full` scales q before the QK
product (as the flash kernel and its oracle do) where ``repro``'s
``attend_full`` scales the logits after it — that keeps the CPU flip
bitwise and reassociates one f32 multiply against the JAX package (within
the 2e-5 f32 attention contract).

:func:`attend_decode` has its own numerics, the reference's: bf16 cache
operands with f32 sums. A bf16 product on CUDA rounds its output to bf16,
so the port upcasts the cache's live prefix (the positions a length
allows; the rest is masked to an exact zero weight) and multiplies in f32:
the bf16 products are exact in f32, only the summation order differs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, masked_attention
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.utils.pspec import spec


def rmsnorm(x, w, eps=1e-6, use_kernel=False):
    """RMSNorm; ``use_kernel`` dispatches to the CUDA kernel on the card."""
    return rmsnorm_ops.rmsnorm(x, w, eps, use_kernel=use_kernel)


def rope_freqs(head_dim: int, theta: float, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x, angles):
    """Split-half rotation of x [B, S, H, Dh] by angles [B, S, Dh/2], in
    f32, back to x's dtype."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE. x: [B, S, H, Dh]; positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [Dh/2]
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x, positions3, theta: float, sections: tuple):
    """Qwen2-VL M-RoPE. x: [B, S, H, Dh]; positions3: [3, B, S] (t, h, w)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # [Dh/2]
    # each frequency slot takes its position id from its (t|h|w) section
    # (expanded views: no index tensor to copy to the device)
    p3 = positions3.to(torch.float32)
    pos = torch.cat([p3[i, None].expand(n, *p3.shape[1:])
                     for i, n in enumerate(sections)]).movedim(0, -1)
    return _rotate(x, pos * freqs)


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
    """x: [B, S, D] -> q [B, S, H, Dh], k/v [B, S, KV, Dh] (RoPE applied;
    M-RoPE when ``cfg.mrope_sections``, positions then [3, B, S])."""
    theta = cfg.rope_theta if theta is None else theta
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if positions is not None:
        if cfg.mrope_sections:
            q = apply_mrope(q, positions, theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, theta, cfg.mrope_sections)
        else:
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


def _group_q(q, num_kv: int):
    """[B, S, H, Dh] -> [B, S, KV, G, Dh]."""
    b, s, h, dh = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, dh)


def attend_chunked(q, k, v, q_pos, k_pos, causal: bool, chunk: int = 1024,
                   scale: Optional[float] = None, prob_dtype=None):
    """Online-softmax attention over KV chunks (the reference's scan as a
    loop). Memory high-water ~ [B, H, Sq, chunk]. ``prob_dtype=bf16`` casts
    the probabilities before the PV product; max and denominator stay
    f32."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    big = torch.iinfo(torch.int32).max
    if sk % chunk != 0:
        pad = chunk - sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=big)
        sk += pad
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = _group_q(q, kvh).to(torch.float32) * scale  # [B,Sq,KV,G,Dh]
    g = h // kvh
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_ = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, dh), dtype=torch.float32,
                      device=q.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    for c in range(sk // chunk):
        kj = k[:, c * chunk:(c + 1) * chunk]
        vj = v[:, c * chunk:(c + 1) * chunk]
        pj = k_pos[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhgk,bchk->bhgqc", qg, kj.to(torch.float32))
        valid = pj[:, None, None, None, :] <= big - 1
        if causal:
            valid = valid & (q_pos[:, None, None, :, None]
                             >= pj[:, None, None, None, :])
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_ = l_ * corr + p.sum(dim=-1)
        if prob_dtype is not None:
            pv = torch.einsum("bhgqc,bchk->bqhgk", p.to(prob_dtype),
                              vj.to(prob_dtype)).to(torch.float32)
        else:
            pv = torch.einsum("bhgqc,bchk->bqhgk", p, vj.to(torch.float32))
        acc = acc * corr.movedim(3, 1)[..., None] + pv
        m = m_new
    l_ = torch.clamp_min(l_, 1e-30)
    out = acc / l_.movedim(3, 1)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attend_decode(q, k_cache, v_cache, cur_len,
                  scale: Optional[float] = None):
    """Decode: q [B, 1, H, Dh] against cache [B, Smax, KV, Dh]. Row ``b``
    attends to positions ``s < cur_len[b]``: ``cur_len`` is the reference's
    int32 [B] on q's device (masked over the whole ``Smax``), or one host
    int for the whole batch (then only that prefix is read).

    The reference's numerics: q cast to the cache dtype and scaled in it,
    both products of cache-dtype operands summed in f32, softmax in f32,
    the weights cast to the V dtype before PV, the output in q's dtype.
    Positions past a host length are masked in the reference, so they add
    exact zeros there; reading only the prefix upcasts only it to f32.
    """
    b, _, h, dh = q.shape
    smax, kvh = k_cache.shape[1], k_cache.shape[2]
    live = cur_len if isinstance(cur_len, int) else smax
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = _group_q(q, kvh).to(k_cache.dtype) * torch.full(
        (), scale, dtype=k_cache.dtype, device=q.device)  # [B,1,KV,G,Dh]
    s = torch.einsum("bqhgk,bshk->bhgqs", qg.to(torch.float32),
                     k_cache[:, :live].to(torch.float32))
    if not isinstance(cur_len, int):
        pos = torch.arange(live, dtype=torch.int32, device=q.device)
        mask = pos[None, None, None, None, :] < \
            cur_len[:, None, None, None, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                            device=s.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk",
                       w.to(v_cache.dtype).to(torch.float32),
                       v_cache[:, :live].to(torch.float32))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def attend(q, k, v, q_pos, k_pos, causal: bool, impl: str = "auto",
           chunk: int = 1024, scale: Optional[float] = None,
           use_kernel=False):
    """GQA attention; ``use_kernel`` dispatches CUDA tensors to the flash
    kernel. The kernel derives the causal mask from 0-based positions —
    what every backbone path passes — and masks Sq/Sk tails itself, so
    unlike the reference no shape falls back to another path. Otherwise
    (and for CPU tensors whatever ``use_kernel`` says, which keeps the flag
    bitwise-neutral there) ``impl`` picks the plain path: ``"auto"`` is
    ``"chunked"`` past 2048 keys, else ``"full"``."""
    if use_kernel and on_cuda(q):
        return flash_ops.attend(q, k, v, causal=causal, scale=scale)
    if impl == "auto":
        impl = "chunked" if k.shape[1] > 2048 else "full"
    if impl == "full":
        return attend_full(q, k, v, q_pos, k_pos, causal, scale)
    if impl == "chunked":
        return attend_chunked(q, k, v, q_pos, k_pos, causal, chunk, scale)
    if impl == "chunked_bf16p":
        return attend_chunked(q, k, v, q_pos, k_pos, causal, chunk, scale,
                              prob_dtype=torch.bfloat16)
    raise ValueError(f"unknown attention impl {impl}")


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


def activation(cfg: ModelConfig):
    """The gate's activation: tanh-approximate GELU (``jax.nn.gelu``'s
    default) for GeGLU, SiLU otherwise."""
    if cfg.act == "geglu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def mlp(p, cfg: ModelConfig, x):
    act = activation(cfg)
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


def embed(p, cfg: ModelConfig, tokens):
    """Token ids -> embeddings in the compute dtype; gemma's scale by
    sqrt(d_model) is taken after the cast, in that dtype."""
    e = p["tok"][tokens].to(getattr(torch, cfg.compute_dtype))
    if cfg.emb_scale:
        e = e * torch.full((), math.sqrt(cfg.d_model), dtype=e.dtype,
                           device=e.device)
    return e


def unembed(p, cfg: ModelConfig, h):
    """Hidden -> logits in h's dtype (tied: ``tok`` transposed)."""
    w = p["unembed"] if "unembed" in p else p["tok"].T
    return torch.einsum("bsd,dv->bsv", h, w.to(h.dtype))
