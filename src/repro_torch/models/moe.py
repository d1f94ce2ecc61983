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
from repro_torch.dist.sharding import is_dtensor, mesh_einsum, shard_act
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


def _router_logits(p, xg):
    """[G, Tg, E] router logits in f32 (the reference promotes x to the
    router's f32)."""
    return torch.einsum("gtd,de->gte", xg.to(torch.float32),
                        p["router"].to(torch.float32))


def _assign(logits, cfg: ModelConfig, cap: int):
    """The routing of one or more whole groups from their logits [G, Tg, E]
    (a rank's own groups on a mesh): (top_e, top_p, se, st, sp, keep,
    dest, order), see :func:`route`."""
    g, tg, _ = logits.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [G, Tg, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalize
    flat_e = top_e.reshape(g, -1)  # [G, Tg*k]
    flat_t = torch.arange(tg, device=logits.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sp = torch.gather(top_p.reshape(g, -1), 1, order)
    # rank within expert = index - first index of this expert id
    first = torch.searchsorted(se, se, side="left")
    rank = torch.arange(tg * k, device=logits.device) - first
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, torch.full_like(se, e * cap))
    return top_e, top_p, se, st, sp, keep, dest, order


def _sizes(cfg: ModelConfig, x, num_groups: int):
    b, s, _ = x.shape
    t = b * s
    if t % num_groups:
        raise ValueError(f"moe: {t} tokens do not split into {num_groups} "
                         f"groups")
    tg = t // num_groups
    return tg, _capacity(tg, cfg)


def route(p, cfg: ModelConfig, x, num_groups: int = 1) -> dict:
    """The routing of :func:`moe_ffn` for x [B, S, D]: ``top_e``/``top_p``
    [G, Tg, k] (renormalized), and per group the sorted assignment ``se``
    (expert), ``st`` (token), ``sp`` (weight), ``keep`` (within capacity)
    and ``dest`` (buffer row; ``E * cap`` is the drop bucket), each
    [G, Tg * k]; ``cap`` the capacity."""
    tg, cap = _sizes(cfg, x, num_groups)
    xg = x.reshape(num_groups, tg, x.shape[-1])
    names = ("top_e", "top_p", "se", "st", "sp", "keep", "dest", "order")
    r = dict(zip(names, _assign(_router_logits(p, xg), cfg, cap)))
    r["cap"] = cap
    return r


def _pack(logits, xg, cfg: ModelConfig, cap: int):
    """Route a rank's groups and pack their tokens: (buf [G, E, cap, d],
    sp, keep, dest, order)."""
    g, tg, d = xg.shape
    e = cfg.num_experts
    _, _, _, st, sp, keep, dest, order = _assign(logits, cfg, cap)
    # pack: buf[g, dest] = x[g, st]; the drop bucket's row is cut off
    gi = torch.arange(g, device=xg.device)[:, None]
    buf = torch.zeros(g, e * cap + 1, d, dtype=xg.dtype, device=xg.device)
    buf[gi, dest] = xg[gi, st]
    return buf[:, :e * cap].reshape(g, e, cap, d), sp, keep, dest, order


def _combine(out_buf, sp, keep, dest, order, cfg: ModelConfig):
    """[G, Tg, d]: each token's k weighted expert outputs, summed in
    ascending sorted position (ascending expert id), as a sequential
    scatter-add from zeros would; a token's k sorted positions are the
    inverse permutation of the sort at its k flat slots."""
    g, e, cap, d = out_buf.shape
    k = cfg.experts_per_tok
    tg = dest.shape[1] // k
    out_buf = out_buf.reshape(g, e * cap, d)
    gi = torch.arange(g, device=out_buf.device)[:, None]
    vals = out_buf[gi, torch.clamp_max(dest, e * cap - 1)]
    vals = torch.where(keep[..., None], vals,
                       torch.zeros((), dtype=vals.dtype,
                                   device=vals.device))
    vals = vals * sp[..., None].to(vals.dtype)
    inv = torch.argsort(order, dim=-1).reshape(g, tg, k)
    slots = torch.sort(inv, dim=-1).values
    out = vals[gi, slots[..., 0]]
    for j in range(1, k):
        out = out + vals[gi, slots[..., j]]
    return out


def _per_group(fn, n_out: int, *args):
    """``fn(*args)``; on a mesh (DTensor args laid out groups@data, the
    rest replicated) ``fn`` runs on each rank's own groups through
    ``local_map``: the routing's sort and ``searchsorted`` have no DTensor
    sharding rule, and a group's routing needs nothing of another's."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    lay = list(next(a for a in args if is_dtensor(a)).placements)
    out = tuple(lay for _ in range(n_out)) if n_out > 1 else lay
    ins = tuple(lay if is_dtensor(a) else None for a in args)
    return local_map(fn, out_placements=out, in_placements=ins)(*args)


def moe_ffn(p, cfg: ModelConfig, x, num_groups: int = 1):
    """x: [B, S, D] -> [B, S, D]. ``num_groups`` splits the tokens into
    routing groups (the reference's data-parallel shards). On a mesh the
    routing, packing and combine run on each rank's ``groups@data`` shard
    (:func:`_per_group`) and the expert products on DTensors."""
    b, s, d = x.shape
    tg, cap = _sizes(cfg, x, num_groups)
    xg = x.reshape(num_groups, tg, d)
    xg = shard_act(xg, ("groups", None, "embed_act"))
    logits = shard_act(_router_logits(p, xg), ("groups", None, None))
    buf, sp, keep, dest, order = _per_group(
        lambda lg, xl: _pack(lg, xl, cfg, cap), 5, logits, xg)
    buf = shard_act(buf, ("groups", "experts", None, "embed_act"))

    act = L.activation(cfg)
    wg = p["w_gate"].to(buf.dtype)
    wu = p["w_up"].to(buf.dtype)
    wd = p["w_down"].to(buf.dtype)
    h = act(mesh_einsum("gecd,edf->gecf", buf, wg)) * \
        mesh_einsum("gecd,edf->gecf", buf, wu)
    h = shard_act(h, ("groups", "experts", None, "ffn"))
    out_buf = mesh_einsum("gecf,efd->gecd", h, wd)
    out_buf = shard_act(out_buf, ("groups", "experts", None, "embed_act"))
    # the combine reads every expert of its group: experts whole
    out_buf = shard_act(out_buf, ("groups", None, None, "embed_act"))
    out = _per_group(lambda ob, *r: _combine(ob, *r, cfg), 1,
                     out_buf, sp, keep, dest, order)
    out = out.reshape(b, s, d)

    if "shared" in p:
        sh = p["shared"]
        g = torch.einsum("bsd,df->bsf", x, sh["w_gate"].to(x.dtype))
        u = torch.einsum("bsd,df->bsf", x, sh["w_up"].to(x.dtype))
        hh = shard_act(act(g) * u, ("batch", "seq", "ffn"))
        shared_out = torch.einsum("bsf,fd->bsd", hh,
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
    h = h + moe_ffn(p["moe"], cfg, x, num_groups)
    return shard_act(h, ("batch", "seq", "embed_act"))


def forward_hidden(params, cfg, embeds, positions=None, causal=False,
                   attn_impl="auto", remat=False, num_groups=1):
    b, s, _ = embeds.shape
    if positions is None:
        positions = _dense._positions(cfg, b, s, device=embeds.device)

    def body(h, p):
        return _block(cfg, p, h, positions, causal, attn_impl, num_groups)

    h = embeds
    for p in _dense._layers(params["blocks"]):
        h = L.remat_call(remat, body, h, p)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def forward_train(params, cfg, tokens, attn_impl="auto", remat=True,
                  num_groups=1):
    """tokens: [B, S] -> logits [B, S, V], causal."""
    e = shard_act(L.embed(params["embed"], cfg, tokens),
                  ("batch", "seq", "embed_act"))
    h = forward_hidden(params, cfg, e, causal=True, attn_impl=attn_impl,
                       remat=remat, num_groups=num_groups)
    return L.unembed(params["embed"], cfg, h)


# the cache is dense's
init_cache = _dense.init_cache
cache_specs = _dense.cache_specs
cache_axes = _dense.cache_axes


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
