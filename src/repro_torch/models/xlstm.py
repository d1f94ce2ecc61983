"""xLSTM-1.3B — port of ``repro.models.xlstm``: alternating mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, strictly recurrent)
blocks with exponential gating and max-stabilizers. 1 sLSTM per
``slstm_every`` blocks; blocks carry their own up/down projections
(d_ff=0).

Layout: ``num_layers`` blocks = G groups x [(slstm_every-1) mLSTM + 1
sLSTM]; the mLSTM parameters stack two leading dims ``(G, per)``, the
sLSTM ones ``(G,)``. No kernel route, as in the reference: its norms and
products are plain.

The recurrent state is the LM cache (``_zero_states``: ten f32 leaves and
``len`` int32 [B], kept on the host); a decode step updates it in place and
returns it. JAX promotes a bf16 array times a strongly typed f32 scalar to
f32, torch keeps bf16 when the f32 operand is 0-dim, so the products with
the f32 ``scale`` upcast their bf16 side explicitly. Three-operand einsums
are contracted pairwise, never through a [B, Lc, H, hd, hd] intermediate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (assign, conform, is_dtensor,
                                       mesh_einsum, on_rows, rows_layout,
                                       shard_act, split_last, whole_for_rows,
                                       zeros_tree)
from repro_torch.models import layers as L
from repro_torch.models.dense import _layers
from repro_torch.models.mamba2 import _depthwise_causal_conv
from repro_torch.utils.pspec import spec

F32 = torch.float32


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    din = int(cfg.mlstm_proj_factor * d)  # mLSTM inner dim
    h = cfg.num_heads
    return d, din, h, din // h, d // h  # (d, din, H, hd_m, hd_s)


def _groups(cfg: ModelConfig):
    per = cfg.slstm_every
    assert cfg.num_layers % per == 0
    return cfg.num_layers // per, per - 1  # (G, mlstm per group)


def _ffn_dim(d):
    f = int(round(4 * d / 3))
    return -(-f // 64) * 64


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ModelConfig, lead: tuple):
    d, din, h, hd, _ = _dims(cfg)
    la = tuple("layers" for _ in lead)

    def s(shape, axes, **kw):
        return spec(tuple(lead) + tuple(shape), la + tuple(axes), **kw)

    return {
        "ln": s((d,), (None,), init="ones"),
        "w_up": s((d, din), ("embed", "mem")),
        "w_gate": s((d, din), ("embed", "mem")),
        "conv_w": s((cfg.ssm_conv, din), ("conv", "mem"), init="normal",
                    scale=0.5),
        # head-wise (block-diagonal) q/k/v, as in the official LinearHeadwise
        "w_q": s((h, hd, hd), ("heads", "mem", None)),
        "w_k": s((h, hd, hd), ("heads", "mem", None)),
        "w_v": s((h, hd, hd), ("heads", "mem", None)),
        "w_i": s((din, h), ("mem", "heads")),
        "w_f": s((din, h), ("mem", "heads")),
        "b_i": s((h,), ("heads",), init="zeros"),
        "b_f": s((h,), ("heads",), init="ones"),
        "skip": s((din,), ("mem",), init="ones"),
        "out_norm": s((din,), ("mem",), init="ones"),
        "w_down": s((din, d), ("mem", "embed")),
    }


def slstm_specs(cfg: ModelConfig, lead: tuple):
    d, _, h, _, hd = _dims(cfg)
    f = _ffn_dim(d)
    la = tuple("layers" for _ in lead)

    def s(shape, axes, **kw):
        return spec(tuple(lead) + tuple(shape), la + tuple(axes), **kw)

    return {
        "ln": s((d,), (None,), init="ones"),
        "conv_w": s((cfg.ssm_conv, d), ("conv", "embed"), init="normal",
                    scale=0.5),
        "w_gates": s((d, 4, h, hd), ("embed", None, "heads", None)),  # zifo
        "r_gates": s((4, h, hd, hd), (None, "heads", None, None),
                     init="normal", scale=0.02),
        "b_gates": s((4, h, hd), (None, "heads", None), init="zeros"),
        "out_norm": s((d,), (None,), init="ones"),
        "ffn": {
            "w_gate": s((d, f), ("embed", "ffn")),
            "w_up": s((d, f), ("embed", "ffn")),
            "w_down": s((f, d), ("ffn", "embed")),
        },
    }


def specs(cfg: ModelConfig) -> dict:
    g, m_per = _groups(cfg)
    return {
        "embed": L.embed_specs(cfg),
        "mlstm": mlstm_specs(cfg, (g, m_per)),
        "slstm": slstm_specs(cfg, (g,)),
        "final_norm": spec((cfg.d_model,), (None,), init="ones"),
    }


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel + recurrent step
# ---------------------------------------------------------------------------


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x) = min(x, 0) - log1p(exp(-|x|))
    (the same bits: negation is exact and rounding symmetric)."""
    return torch.clamp_max(x, 0.0) - torch.log1p(torch.exp(-x.abs()))


def _scale(hd: int, device):
    """``1.0 / jnp.sqrt(hd).astype(float32)``: sqrt and quotient in f32."""
    return 1.0 / torch.sqrt(torch.full((), float(hd), dtype=F32,
                                       device=device))


def _mlstm_chunkwise(q, k, v, ig, fg, state, chunk):
    """q/k/v: [B,S,H,hd]; ig/fg: [B,S,H] raw gate pre-activations.

    Returns (h [B,S,H,hd] f32, new_state). State = (c [B,H,hd,hd],
    n [B,H,hd], m [B,H]).
    """
    b, s, h, hd = q.shape
    lc = min(chunk, s)
    assert s % lc == 0
    nc = s // lc
    scale = _scale(hd, q.device)
    # on a mesh each chunked view's gradient is laid out as the view
    # (``conform``): DTensor's backward may split the sequence over ranks
    # that do not divide the chunks
    qc, kc, vc = (conform(t.reshape(b, nc, lc, h, hd).to(F32))
                  for t in (q, k, v))
    igc, fgc = (conform(t.reshape(b, nc, lc, h).to(F32)) for t in (ig, fg))
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=q.device))
    neg = torch.full((), float("-inf"), dtype=F32, device=q.device)
    c_p, n_p, m_p = state
    hs = []
    for j in range(nc):
        qj, kj, vj, ij, fj = (t[:, j] for t in (qc, kc, vc, igc, fgc))
        blogf = torch.cumsum(_log_sigmoid(fj), dim=1)  # [B,Lc,H]
        total = blogf[:, -1, :]  # [B,H]
        # intra-chunk log weights S[l,m] = blogf_l - blogf_m + i_m (m <= l)
        s_lm = blogf[:, :, None, :] - blogf[:, None, :, :] + ij[:, None, :, :]
        s_lm = torch.where(mask[None, :, :, None], s_lm, neg)
        m_intra = s_lm.amax(dim=2)  # [B,Lc,H]
        m_inter = m_p[:, None, :] + blogf  # [B,Lc,H]
        m_comb = torch.maximum(m_intra, m_inter)
        w_intra = torch.exp(s_lm - m_comb[:, :, None, :])  # [B,Lc,Lc,H]
        w_inter = torch.exp(m_inter - m_comb)  # [B,Lc,H]
        a = torch.einsum("blhd,bmhd->blmh", qj, kj) * scale * w_intra
        # on a mesh the local results of num's and den's first products
        # came out in strides that DTensor could not view (``mesh_einsum``)
        num = mesh_einsum("blmh,bmhd->blhd", a, vj)
        num = num + w_inter[..., None] * torch.einsum(
            "blhd,bhde->blhe", qj * scale, c_p)
        den = a.sum(dim=2) + w_inter * mesh_einsum("blhd,bhd->blh",
                                                   qj * scale, n_p)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_comb))[..., None])
        # state update to the end of the chunk
        m_new = torch.maximum(m_p + total,
                              (total[:, None, :] - blogf + ij).amax(dim=1))
        w_st = torch.exp(total[:, None, :] - blogf + ij
                         - m_new[:, None, :])  # [B,Lc,H]
        decay = torch.exp(m_p + total - m_new)
        wk = w_st[..., None] * kj  # [B,Lc,H,hd]
        c_p = decay[:, :, None, None] * c_p \
            + torch.einsum("bmhd,bmhe->bhde", wk, vj)
        n_p = decay[:, :, None] * n_p + wk.sum(dim=1)
        m_p = m_new
    hseq = conform(torch.stack(hs, dim=1).reshape(b, s, h, hd))
    return hseq, (c_p, n_p, m_p)


def _mlstm_step(q, k, v, ig, fg, state):
    """Single-token recurrent mLSTM. q/k/v: [B,H,hd]; ig/fg: [B,H]."""
    c_p, n_p, m_p = state
    scale = _scale(q.shape[-1], q.device)
    logf = _log_sigmoid(fg)
    m_new = torch.maximum(logf + m_p, ig)
    i_ = torch.exp(ig - m_new)
    f_ = torch.exp(logf + m_p - m_new)
    c_new = f_[:, :, None, None] * c_p + i_[:, :, None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v).to(F32)
    n_new = f_[:, :, None] * n_p + i_[:, :, None] * k.to(F32)
    qs = q.to(F32) * scale
    num = torch.einsum("bhd,bhde->bhe", qs, c_new)
    den = torch.einsum("bhd,bhd->bh", qs, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, (c_new, n_new, m_new)


def _mlstm_block(p, cfg, x, state=None, conv_state=None, step=False):
    """x: [B,S,D] (S=1 if step). Returns (out, (state, conv_state))."""
    d, din, h, hd, _ = _dims(cfg)
    b = x.shape[0]
    xin = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    u = torch.einsum("bsd,dk->bsk", xin, p["w_up"].to(x.dtype))
    g = torch.einsum("bsd,dk->bsk", xin, p["w_gate"].to(x.dtype))
    u = shard_act(u, ("batch", "seq", "mem"))
    if conv_state is not None:
        conv_state = conv_state.to(u.dtype)
    cv, new_conv = _depthwise_causal_conv(u, p["conv_w"].to(x.dtype),
                                          conv_state)
    cv = F.silu(cv)
    cvh = split_last(cv, (b, -1, h, hd))
    uh = split_last(u, (b, -1, h, hd))
    q = torch.einsum("bshk,hkj->bshj", cvh, p["w_q"].to(x.dtype))
    k = torch.einsum("bshk,hkj->bshj", cvh, p["w_k"].to(x.dtype))
    v = torch.einsum("bshk,hkj->bshj", uh, p["w_v"].to(x.dtype))
    ig = torch.einsum("bsk,kh->bsh", cv, p["w_i"].to(x.dtype)).to(F32) \
        + p["b_i"].to(F32)
    fg = torch.einsum("bsk,kh->bsh", cv, p["w_f"].to(x.dtype)).to(F32) \
        + p["b_f"].to(F32)
    if state is None:
        state = (torch.zeros((b, h, hd, hd), dtype=F32, device=x.device),
                 torch.zeros((b, h, hd), dtype=F32, device=x.device),
                 torch.zeros((b, h), dtype=F32, device=x.device))
    if step:
        hout, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                      fg[:, 0], state)
        hout = hout[:, None]
    else:
        hout, new_state = _mlstm_chunkwise(q, k, v, ig, fg, state,
                                           cfg.ssm_chunk)
    hout = hout.reshape(b, -1, din).to(x.dtype)
    hout = hout + p["skip"].to(x.dtype) * cv
    hout = L.rmsnorm(hout, p["out_norm"], cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", hout * F.silu(g),
                       p["w_down"].to(x.dtype))
    return x + out, (new_state, new_conv)


# ---------------------------------------------------------------------------
# sLSTM cell (strictly sequential)
# ---------------------------------------------------------------------------


def _slstm_scan(p, cfg, x, state, conv_state):
    """x: [B,S,D]. state = (c, n, m, hprev) each [B,H,hd]."""
    d, _, h, _, hd = _dims(cfg)
    b, s, _ = x.shape
    if conv_state is not None:
        conv_state = conv_state.to(x.dtype)
    cv, new_conv = _depthwise_causal_conv(x, p["conv_w"].to(x.dtype),
                                          conv_state)
    cv = F.silu(cv)
    # input contributions for all gates, all steps: [B,S,4,H,hd]
    wx = torch.einsum("bsd,dghk->bsghk", cv,
                      p["w_gates"].to(x.dtype)).to(F32)
    wx = wx + p["b_gates"].to(F32)
    r = p["r_gates"].to(F32)
    c_p, n_p, m_p, h_p = state
    hs = []
    for t in range(s):
        rh = torch.einsum("bhk,ghkj->bghj", h_p, r)  # [B,4,H,hd]
        zt, it, ft, ot = (wx[:, t] + rh).unbind(1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        logf = _log_sigmoid(ft)
        m_new = torch.maximum(logf + m_p, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(logf + m_p - m_new)
        c_p = f_ * c_p + i_ * zt
        n_p = torch.clamp_min(f_ * n_p + i_, 1e-6)
        m_p = m_new
        h_p = ot * (c_p / n_p)
        hs.append(h_p)
    hs = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return hs, (c_p, n_p, m_p, h_p), new_conv


def _slstm_block(p, cfg, x, state=None, conv_state=None):
    d, _, h, _, hd = _dims(cfg)
    b = x.shape[0]
    xin = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    if state is None:
        z = torch.zeros((b, h, hd), dtype=F32, device=x.device)
        state = (z, z + 1e-6, z, z)
    if is_dtensor(xin):
        # on a mesh each rank runs its rows' recurrence with the cell's
        # parameters whole: a step of it is a few small products, and
        # its heads (4 at full width) seldom divide the model ranks
        rows = rows_layout(xin)
        pw = {k: whole_for_rows(p[k], rows)
              for k in ("conv_w", "w_gates", "b_gates", "r_gates")}
        hs, new_state, new_conv = on_rows(
            lambda xl, st, cs: _slstm_scan(pw, cfg, xl, st, cs), xin, state,
            conv_state)
    else:
        hs, new_state, new_conv = _slstm_scan(p, cfg, xin, state,
                                              conv_state)
    hs = L.rmsnorm(hs, p["out_norm"], cfg.norm_eps)
    x = x + hs
    # post-FFN (GeGLU, factor 4/3), on the un-normed sum as in the reference
    return x + L.mlp(p["ffn"], cfg.replace(act="geglu"), x), \
        (new_state, new_conv)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def cache_axes(cfg: ModelConfig):
    return {
        # the matrix memory shards its output dim (e), as the reference's
        "m_c": ("layers", None, "batch", "heads", None, "mem"),
        "m_n": ("layers", None, "batch", "heads", "mem"),
        "m_m": ("layers", None, "batch", "heads"),
        "m_conv": ("layers", None, "batch", "conv", "mem"),
        "s_c": ("layers", "batch", "heads", None),
        "s_n": ("layers", "batch", "heads", None),
        "s_m": ("layers", "batch", "heads", None),
        "s_h": ("layers", "batch", "heads", None),
        "s_conv": ("layers", "batch", "conv", "embed"),
        "len": ("batch",),
    }


def cache_specs(cfg: ModelConfig, batch, max_len=None, dtype=None):
    """The recurrent state's leaves as ``(shape, dtype)`` (no ``max_len``:
    its size does not grow with the sequence)."""
    d, din, h, hd, hds = _dims(cfg)
    g, m_per = _groups(cfg)
    w = cfg.ssm_conv
    return {
        "m_c": ((g, m_per, batch, h, hd, hd), F32),
        "m_n": ((g, m_per, batch, h, hd), F32),
        "m_m": ((g, m_per, batch, h), F32),
        "m_conv": ((g, m_per, batch, w - 1, din), F32),
        "s_c": ((g, batch, h, hds), F32),
        "s_n": ((g, batch, h, hds), F32),
        "s_m": ((g, batch, h, hds), F32),
        "s_h": ((g, batch, h, hds), F32),
        "s_conv": ((g, batch, w - 1, d), F32),
        "len": ((batch,), torch.int32),
    }


def _zero_states(cfg, b, device):
    """Zeros (``s_n`` 1e-6) on ``device``; ``len`` on the host. Under a
    mesh context each leaf is laid out by :func:`cache_axes`, every rank
    holding only its block (``dist.sharding.zeros_tree``)."""
    out = zeros_tree(cache_specs(cfg, b), cache_axes(cfg), device,
                     skip=("len",))
    out["s_n"].fill_(1e-6)
    return out


def init_cache(cfg: ModelConfig, batch, max_len=None, dtype=None,
               device="cuda"):
    return _zero_states(cfg, batch, resolve_device(device))


def _run(params, cfg, e, cache, step: bool, remat: bool = False):
    """Every block over ``e`` [B, S, D]. ``cache`` None runs each block
    from zero states (conv states None), keeps the states as values and
    writes nothing, so autograd sees no in-place update and no state
    buffer is allocated; ``remat`` then recomputes each group (its mLSTM
    blocks and the sLSTM block) in the backward pass, as the reference
    checkpoints its group body. A cache is read and updated in place
    (``len`` += S) and returned."""
    g, m_per = _groups(cfg)
    mlstm = [_layers(p) for p in _layers(params["mlstm"])]
    slstm = _layers(params["slstm"])
    if cache is None:
        def group(h, gi):
            for j in range(m_per):
                h, _ = _mlstm_block(mlstm[gi][j], cfg, h, step=step)
            h, _ = _slstm_block(slstm[gi], cfg, h)
            return h

        h = e
        for gi in range(g):
            h = L.remat_call(remat, group, h, gi)
        return h, None
    st = cache
    h = e
    for gi in range(g):
        for j in range(m_per):
            h, ((c_, n_, m_), cv_) = _mlstm_block(
                mlstm[gi][j], cfg, h,
                (st["m_c"][gi, j], st["m_n"][gi, j], st["m_m"][gi, j]),
                st["m_conv"][gi, j], step=step)
            for key, val in (("m_c", c_), ("m_n", n_), ("m_m", m_),
                             ("m_conv", cv_)):
                assign(st[key], (gi, j), val.to(F32))
        h, ((sc, sn, sm, sh), scv) = _slstm_block(
            slstm[gi], cfg, h,
            (st["s_c"][gi], st["s_n"][gi], st["s_m"][gi], st["s_h"][gi]),
            st["s_conv"][gi])
        for key, val in (("s_c", sc), ("s_n", sn), ("s_m", sm), ("s_h", sh),
                         ("s_conv", scv)):
            assign(st[key], gi, val.to(F32))
    st["len"] += e.shape[1]
    return h, st


def forward_hidden(params, cfg: ModelConfig, embeds, positions=None,
                   causal=True, attn_impl=None, remat=False, cache=None):
    """embeds: [B, S, D] -> hidden [B, S, D] (causal: the recurrence runs
    forward in sequence order)."""
    h, _ = _run(params, cfg, embeds, cache, step=False, remat=remat)
    return L.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def forward_train(params, cfg: ModelConfig, tokens, attn_impl=None,
                  remat=True):
    """tokens: [B, S] -> logits [B, S, V]."""
    e = shard_act(L.embed(params["embed"], cfg, tokens),
                  ("batch", "seq", "embed_act"))
    h = forward_hidden(params, cfg, e, remat=remat)
    return L.unembed(params["embed"], cfg, h)


def prefill(params, cfg: ModelConfig, tokens, max_len=None, attn_impl=None):
    """tokens: [B, S] -> (logits [B, S, V], state after S). The zero state
    goes in as a cache, so the conv states run from zeros."""
    e = L.embed(params["embed"], cfg, tokens)
    zero = _zero_states(cfg, tokens.shape[0], e.device)
    h, cache = _run(params, cfg, e, zero, step=False)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h), cache


def decode_step(params, cfg: ModelConfig, tokens, cache, attn_impl=None):
    """tokens: [B, 1]; returns (logits [B, 1, V], cache), the cache updated
    in place."""
    e = L.embed(params["embed"], cfg, tokens)
    h, cache = _run(params, cfg, e, cache, step=True)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], cfg, h), cache
