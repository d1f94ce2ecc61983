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
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (block_range, conform, is_dtensor,
                                       shard_act)
from repro_torch.kernels import mesh as kmesh
from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, masked_attention
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.utils.pspec import spec


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` its activations are recomputed in the
    backward pass: the port of the reference's ``jax.checkpoint`` around a
    layer body. ``torch.utils.checkpoint`` saves the inputs only and
    recomputes the whole body, where the reference's policy
    (``dots_with_no_batch_dims_saveable``) keeps the matmul outputs: the
    values are the same, the time and memory differ."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


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


def _tp_only(w):
    """A projection weight with its FSDP split (``embed`` on ``data``
    under ``TRAIN_RULES``) gathered, the tensor-parallel split kept: the
    gather the product needs anyway, made before it, so that a head dim
    split over ``model`` (heads that do not divide it) stays a head-dim
    split in the product's output. A plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard

    lay = [Replicate() if isinstance(pl, Shard) and pl.dim == 0 and n > 1
           else pl for pl, n in zip(w.placements, w.device_mesh.shape)]
    return w if lay == list(w.placements) else \
        w.redistribute(w.device_mesh, lay)


def qkv_proj(p, cfg: ModelConfig, x, positions, theta=None, cross_kv=None):
    """x: [B, S, D] -> q [B, S, H, Dh], k/v [B, Skv, KV, Dh] (RoPE applied;
    M-RoPE when ``cfg.mrope_sections``, positions then [3, B, S]). With
    ``cross_kv`` [B, Skv, D] (an encoder's memory) k/v project it and take
    no rotation."""
    theta = cfg.rope_theta if theta is None else theta
    src = x if cross_kv is None else cross_kv
    # a memory in another dtype (f32 source frames into a bf16 decoder)
    # promotes the k/v products, as jnp.einsum does
    kdt = torch.promote_types(src.dtype, x.dtype)
    wq, wk, wv = (_tp_only(p[n]) for n in ("wq", "wk", "wv"))
    # on a mesh each product's gradient is laid out as its result before
    # the product's backward views it (``conform``); the operands' own
    # gradients keep DTensor's layout (partial sums reduced once)
    q = conform(torch.einsum("bsd,dhk->bshk", x, wq.to(x.dtype)))
    k = conform(torch.einsum("bsd,dhk->bshk", src.to(kdt),
                             wk.to(x.dtype).to(kdt)))
    v = conform(torch.einsum("bsd,dhk->bshk", src.to(kdt),
                             wv.to(x.dtype).to(kdt)))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if positions is not None:
        if cfg.mrope_sections:
            q = apply_mrope(q, positions, theta, cfg.mrope_sections)
            if cross_kv is None:
                k = apply_mrope(k, positions, theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, theta)
            if cross_kv is None:
                k = apply_rope(k, positions, theta)
    q = shard_act(q, ("batch", "seq", "heads", "head_dim"))
    k = shard_act(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shard_act(v, ("batch", "seq", "kv_heads", "head_dim"))
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
    if is_dtensor(q):  # on a mesh: each rank's rows and heads
        by_row = () if isinstance(cur_len, int) else (cur_len,)
        if kmesh.split_dims(k_cache, 1):
            return _attend_decode_split(q, k_cache, v_cache, cur_len, scale,
                                        by_row)
        return kmesh.local_shards(
            "attend_decode",
            lambda a, b, c, *cl: attend_decode(a, b, c, *(cl or (cur_len,)),
                                               scale=scale),
            (q, k_cache, v_cache), whole=((1, 3),) * 3, same_layout=(1, 2),
            rows=by_row)
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


def _attend_decode_split(q, k_cache, v_cache, cur_len, scale, by_row):
    """:func:`attend_decode` on a mesh whose layout splits the cache's
    sequence (dim 1): the softmax reduced across the sequence blocks in
    place, as XLA reduces the reference's, where gathering the cache
    would move all of it every layer and step. Each rank scores its own
    block (its rows and heads as :func:`kmesh.local_shards` lays them
    out); the row max, the softmax's denominator and the PV product's
    partial sums are then all-reduced over the mesh dims of the split:
    B·H·(Dh + 2) f32 a rank on the wire. The denominator is reduced
    before the PV product, so that the weights are normalized before
    their cast to the V dtype, as in the reference."""
    from repro_torch.dist.sharding import reduce_blocks

    mesh = k_cache.device_mesh
    seq = kmesh.split_dims(k_cache, 1)
    start, _ = block_range(k_cache.shape[1], 1, mesh, k_cache.placements)

    def reduce(t, op):
        return reduce_blocks(t, mesh, seq, op)

    def block(qb, kb, vb, *cl):
        return _decode_block(qb, kb, vb, cl[0] if cl else cur_len, scale,
                             start, reduce)

    return kmesh.local_shards(
        "attend_decode", block, (q, k_cache, v_cache),
        whole=((1, 3), (3,), (3,)), same_layout=(1, 2), rows=by_row,
        reduce_over=seq)


def _decode_block(q, k_cache, v_cache, cur_len, scale, start, reduce):
    """One rank's part of :func:`_attend_decode_split`: q [B, 1, H, Dh]
    against the cache block [B, n, KV, Dh] that holds positions
    ``[start, start + n)``. ``reduce(t, op)`` reduces a partial result
    across the blocks. A block wholly past the length adds exact zeros
    (its max is ``NEG_INF``, which the reduced max outweighs); a host
    length reads only the block's live prefix."""
    b, _, h, dh = q.shape
    n, kvh = k_cache.shape[1], k_cache.shape[2]
    host = isinstance(cur_len, int)
    live = min(max(cur_len - start, 0), n) if host else n
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = _group_q(q, kvh).to(k_cache.dtype) * torch.full(
        (), scale, dtype=k_cache.dtype, device=q.device)  # [B,1,KV,G,Dh]
    s = torch.einsum("bqhgk,bshk->bhgqs", qg.to(torch.float32),
                     k_cache[:, :live].to(torch.float32))
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=s.device)
    if not host:
        pos = start + torch.arange(n, dtype=torch.int32, device=q.device)
        mask = pos[None, None, None, None, :] < \
            cur_len[:, None, None, None, None]
        s = torch.where(mask, s, neg)
    m = s.amax(dim=-1) if live else neg.expand(s.shape[:-1]).contiguous()
    m = reduce(m, "max")
    p = torch.exp(s - m[..., None])
    den = reduce(p.sum(dim=-1), "sum")
    w = p / den[..., None]
    out = torch.einsum("bhgqs,bshk->bqhgk",
                       w.to(v_cache.dtype).to(torch.float32),
                       v_cache[:, :live].to(torch.float32))
    return reduce(out, "sum").reshape(b, 1, h, dh).to(q.dtype)


def attend(q, k, v, q_pos, k_pos, causal: bool, impl: str = "auto",
           chunk: int = 1024, scale: Optional[float] = None,
           use_kernel=False):
    """GQA attention; ``use_kernel`` dispatches CUDA tensors to the flash
    kernel. The kernel derives the causal mask from 0-based positions —
    what every backbone path passes — and masks Sq/Sk tails itself, so
    unlike the reference no shape falls back to another path. Otherwise
    (and for CPU tensors whatever ``use_kernel`` says, which keeps the flag
    bitwise-neutral there) ``impl`` picks the plain path: ``"auto"`` is
    ``"chunked"`` past 2048 keys, else ``"full"``. On a mesh (DTensor
    q/k/v) each rank attends its own rows and heads, the sequences and the
    head dim whole (``kernels/mesh.py``): the reshapes of the grouped
    heads are local, where DTensor would refuse to flatten a sharded
    heads dim."""
    if is_dtensor(q):
        return kmesh.local_shards(
            "flash_attention" if use_kernel else "attention",
            lambda a, b, c, qp, kp: attend(a, b, c, qp, kp, causal, impl,
                                           chunk, scale, use_kernel),
            (q, k, v), whole=((1, 3),) * 3, same_layout=(1, 2),
            rows=(q_pos, k_pos))
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
    h = shard_act(act(g) * u, ("batch", "seq", "ffn"))
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))


def embed_specs(cfg: ModelConfig):
    specs = {"tok": spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         init="embed", scale=1.0 / math.sqrt(cfg.d_model))}
    if not cfg.tie_embeddings:
        specs["unembed"] = spec((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))
    return specs


def _lookup_on_rows(table, tokens):
    """The embedding lookup on a mesh, vocab-parallel: the table's embed
    dim gathered (the FSDP gather), its vocab rows kept split where the
    layout splits them. Each rank looks up its own rows of ``tokens``
    among the vocab rows it holds, zeros for the ids it does not hold, and
    the sum over the mesh dims that split the vocab (an all-reduce of the
    [rows, S, D] embeddings) gives every rank its rows' embeddings: no
    rank holds more of the table than its vocab block. The table's
    gradient is declared partial over the mesh dims that split the token
    rows (each rank holds its rows' part of it), so autograd reduces it
    back onto the table's layout. DTensor's own lookup is not used: its
    backward (``index_put``) fails on a sharded table in some releases."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in tokens.placements]
    vocab = [isinstance(p, Shard) and p.dim == 0 and not r
             for p, r in zip(table.placements, rows)]
    lay = [Shard(0) if v else Replicate() for v in vocab]
    local = table.redistribute(mesh, lay).to_local(grad_placements=[
        Partial() if r else q for r, q in zip(rows, lay)])
    start, n = block_range(table.shape[0], 0, mesh, lay)
    ids = tokens.to_local() - start
    held = (ids >= 0) & (ids < n)
    out = torch.where(held[..., None], local[torch.where(held, ids, 0)],
                      torch.zeros((), dtype=local.dtype, device=local.device))
    out_lay = [Shard(0) if r else Replicate() for r in rows]
    part = [Partial() if v else q for v, q in zip(vocab, out_lay)]
    return DTensor.from_local(out, mesh, part, run_check=False).redistribute(
        mesh, out_lay)


def embed(p, cfg: ModelConfig, tokens):
    """Token ids -> embeddings in the compute dtype; gemma's scale by
    sqrt(d_model) is taken after the cast, in that dtype."""
    e = (_lookup_on_rows(p["tok"], tokens) if is_dtensor(tokens)
         else p["tok"][tokens]).to(getattr(torch, cfg.compute_dtype))
    if cfg.emb_scale:
        e = e * torch.full((), math.sqrt(cfg.d_model), dtype=e.dtype,
                           device=e.device)
    return e


def unembed(p, cfg: ModelConfig, h):
    """Hidden -> logits in h's dtype (tied: ``tok`` transposed)."""
    w = p["unembed"] if "unembed" in p else p["tok"].T
    return torch.einsum("bsd,dv->bsv", h, w.to(h.dtype))
