"""Mixture-of-Experts transformer — port of ``repro.models.moe``
(qwen2-moe-a2.7b, olmoe-1b-7b).

The MoE layer is the reference's sort-based dropping dispatch: tokens are
routed top-k, sorted by expert id within groups, packed into ``[groups,
experts, capacity, d]`` buffers and run through batched expert products;
tokens past an expert's capacity are dropped. As in the reference, the
blocks take no kernel route: norms and attention stay plain whatever
``use_kernels`` says.

The combine differs from the reference in form only: where it scatter-adds
each routed token's weighted output, the port gathers a token's k outputs
in the order a sequential scatter would add them (ascending expert id) and
sums them one by one. On the card that order is fixed, where a bf16
``index_add_`` is atomic and not reproducible run to run.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense as _dense
from repro_torch.models import layers as L
from repro_torch.utils.pspec import spec


def moe_specs(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)

    def s(shape, axes, **kw):
        return spec(lead + tuple(shape), lax_ + tuple(axes), **kw)

    specs = {
        "router": s((d, e), ("embed", "experts")),
        "w_gate": s((e, d, f), ("experts", "embed", "ffn")),
        "w_up": s((e, d, f), ("experts", "embed", "ffn")),
        "w_down": s((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.d_ff * cfg.num_shared_experts
        specs["shared"] = {
            "w_gate": s((d, fs), ("embed", "ffn")),
            "w_up": s((d, fs), ("embed", "ffn")),
            "w_down": s((fs, d), ("ffn", "embed")),
            "gate": s((d, 1), ("embed", None)),
        }
    return specs


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_group * cfg.experts_per_tok * cfg.moe_capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(p, cfg: ModelConfig, x, num_groups: int = 1) -> dict:
    """The routing of :func:`moe_ffn` for x [B, S, D]: ``top_e``/``top_p``
    [G, Tg, k] (renormalized), and per group the sorted assignment ``se``
    (expert), ``st`` (token), ``sp`` (weight), ``keep`` (within capacity)
    and ``dest`` (buffer row; ``E * cap`` is the drop bucket), each
    [G, Tg * k]; ``cap`` the capacity."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    t = b * s
    if t % num_groups:
        raise ValueError(f"moe: {t} tokens do not split into {num_groups} "
                         f"groups")
    tg = t // num_groups
    cap = _capacity(tg, cfg)
    xg = x.reshape(num_groups, tg, d)
    # the router product in f32 (the reference promotes x to the router's
    # f32)
    logits = torch.einsum("gtd,de->gte", xg.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [G, Tg, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalize
    flat_e = top_e.reshape(num_groups, -1)  # [G, Tg*k]
    flat_t = torch.arange(tg, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sp = torch.gather(top_p.reshape(num_groups, -1), 1, order)
    # rank within expert = index - first index of this expert id
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(tg * k, device=x.device) - first
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, torch.full_like(se, e * cap))
    return {"top_e": top_e, "top_p": top_p, "se": se, "st": st, "sp": sp,
            "keep": keep, "dest": dest, "order": order, "cap": cap}


def moe_ffn(p, cfg: ModelConfig, x, num_groups: int = 1):
    """x: [B, S, D] -> [B, S, D]. ``num_groups`` splits the tokens into
    routing groups (the reference's data-parallel shards)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    r = route(p, cfg, x, num_groups)
    cap, st, keep, dest = r["cap"], r["st"], r["keep"], r["dest"]
    tg = b * s // num_groups
    xg = x.reshape(num_groups, tg, d)
    # pack: buf[g, dest] = x[g, st]; the drop bucket's row is cut off
    gi = torch.arange(num_groups, device=x.device)[:, None]
    buf = torch.zeros(num_groups, e * cap + 1, d, dtype=x.dtype,
                      device=x.device)
    buf[gi, dest] = xg[gi, st]
    buf = buf[:, :e * cap].reshape(num_groups, e, cap, d)

    act = L.activation(cfg)
    wg = p["w_gate"].to(buf.dtype)
    wu = p["w_up"].to(buf.dtype)
    wd = p["w_down"].to(buf.dtype)
    h = act(torch.einsum("gecd,edf->gecf", buf, wg)) * \
        torch.einsum("gecd,edf->gecf", buf, wu)
    out_buf = torch.einsum("gecf,efd->gecd", h, wd).reshape(
        num_groups, e * cap, d)

    # combine: the weighted outputs in sorted order ...
    vals = out_buf[gi, torch.clamp_max(dest, e * cap - 1)]
    vals = torch.where(keep[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                          device=x.device))
    vals = vals * r["sp"][..., None].to(vals.dtype)
    # ... summed per token in ascending sorted position (ascending expert
    # id), as a sequential scatter-add from zeros would: a token's k
    # sorted positions are the inverse permutation of the sort at its k
    # flat slots
    inv = torch.argsort(r["order"], dim=-1).reshape(num_groups, tg, k)
    slots = torch.sort(inv, dim=-1).values
    out = vals[gi, slots[..., 0]]
    for j in range(1, k):
        out = out + vals[gi, slots[..., j]]
    out = out.reshape(b, s, d)

    if "shared" in p:
        sh = p["shared"]
        g = torch.einsum("bsd,df->bsf", x, sh["w_gate"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, sh["w_up"].to(x.dtype))
        shared_out = torch.einsum("bsf,fd->bsd", act(g) * u,
                                  sh["w_down"].to(x.dtype))
        gate = torch.sigmoid(torch.einsum("bsd,dz->bsz", x,
                                          sh["gate"].to(x.dtype)))
        out = out + gate * shared_out
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Full model: dense attention + MoE FFN
# ---------------------------------------------------------------------------


def specs(cfg: ModelConfig) -> dict:
    n = cfg.num_layers
    return {
        "embed": L.embed_specs(cfg),
        "blocks": {
            "ln1": spec((n, cfg.d_model), ("layers", None), init="ones"),
            "attn": L.attention_specs(cfg, layers=n),
            "ln2": spec((n, cfg.d_model), ("layers", None), init="ones"),
            "moe": moe_specs(cfg, layers=n),
        },
        "final_norm": spec((cfg.d_model,), (None,), init="ones"),
    }


def _block(cfg, p, h, positions, causal, attn_impl, num_groups, cache=None,
           cur=None):
    """A MoE block: plain norms and attention (the reference passes no
    kernel flag here), then the MoE FFN."""
    x = L.rmsnorm(h, p["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_proj(p["attn"], cfg, x, positions)
    attn = _dense.attend_or_decode(cfg, q, k, v, positions, causal,
                                   attn_impl, cache, cur)
    h = h + L.out_proj(p["attn"], attn)
    x = L.rmsnorm(h, p["ln2"], cfg.norm_eps)
    return h + moe_ffn(p["moe"], cfg, x, num_groups)


def forward_hidden(params, cfg, embeds, positions=None, causal=False,
                   attn_impl="auto", num_groups=1):
    b, s, _ = embeds.shape
    if positions is None:
        positions = _dense._positions(cfg, b, s, device=embeds.device)
    h = embeds
    for i in range(cfg.num_layers):
        h = _block(cfg, _dense._layer(params["blocks"], i), h, positions,
                   causal, attn_impl, num_groups)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


# the cache is dense's
init_cache = _dense.init_cache
cache_specs = _dense.cache_specs


def prefill(params, cfg, tokens, max_len, attn_impl="auto", num_groups=1):
    """tokens: [B, S] -> (logits [B, S, V], cache filled to S)."""
    def block(p, h, positions, kv):
        return _block(cfg, p, h, positions, True, attn_impl, num_groups,
                      cache=kv)

    return _dense.run_prefill(params, cfg,
                              L.embed(params["embed"], cfg, tokens), block,
                              max_len)


def decode_step(params, cfg, tokens, cache, attn_impl="auto", num_groups=1):
    """tokens: [B, 1]; returns (logits [B, 1, V], cache)."""
    def block(p, h, positions, kv, cur):
        return _block(cfg, p, h, positions, True, attn_impl, num_groups,
                      cache=kv, cur=cur)

    return _dense.run_decode(params, cfg, tokens, cache, block)
