"""Mamba2 (SSD) layer — port of ``repro.models.mamba2``: the chunked
forward (the denoiser and LM prefill), the O(1) ``ssd_decode_step`` and
the per-layer conv/SSM state specs of the hybrid's LM cache.

``ssd_forward`` has the reference's two arrangements:

* the plain per-chunk scan body (:func:`ssd_scan_plain`): per chunk, the
  masked [Lc, Lc] decay attention, the inter-chunk term from the carried
  [B, H, hd, N] state and the chunk-local state;
* the kernel arrangement (:func:`ssd_scan_chunked`): cumsum hoisted, one
  chunk-function call over the (B·nc, H) grid for every chunk's intra-chunk
  block and local state, and the inter-chunk recurrence as a loop over
  chunks outside it.

With ``cfg.use_kernels`` and CUDA tensors it takes the kernel arrangement
with the ``ssd_chunk`` CUDA kernel; otherwise the plain body, so the flag
is bitwise-neutral on the CPU as ``resolve_kernel_mode`` makes it in the
reference. Three-operand einsums of the reference are contracted pairwise.

On a mesh (DTensor activations under ``use_sharding``) a layer takes one
of two layouts, a pure function of the shapes and the mesh
(:func:`by_heads`):

* *by heads* (:func:`_by_heads`), where the activations a rank would move
  are fewer than the layer's parameters (a decode step, a short prefill),
  and always on a model axis of one rank: ``in_proj`` stays on ``ffn`` and
  each rank multiplies its columns; the [B, S, 2·din + 2N + H] projection
  is gathered over the model axes, each rank keeping z, x and dt of its
  block of heads and B, C whole; the depthwise conv runs on the rank's
  block of conv channels (``conv_w`` and the cache's conv state as they
  are laid out) and its output is gathered; the scan runs on the rank's
  heads, its SSM state never leaving the heads block; the gated norm's
  mean over ``din`` is an all-reduce of the sum of squares, and
  ``out_proj``'s local rows give a partial [B, S, D] that is all-reduced;
* *parameters gathered* (:func:`_on_rows`), where a rank holds many tokens
  (prefill, training): the in-projection packs z, x, B, C and dt along one
  ``ffn`` dim, whose split over the model axes does not follow the heads,
  so the layer's parameters are gathered whole and it runs on each rank's
  rows. The kernel arrangement's ``ssd_chunk`` runs on those rows and this
  rank's block of heads over the model axes (``kernels/ssd_scan/ops.py`` on
  DTensors), its outputs gathered back over them. The states come back
  laid out as the rows; a cache writes its own block of them.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (block_range, current_ctx, is_dtensor,
                                       local_block, mine, on_rows,
                                       rows_layout, whole_for_rows)
from repro_torch.kernels import on_cuda
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.utils.pspec import spec


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def num_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def ssd_specs(cfg: ModelConfig, layers: Optional[int] = None) -> dict:
    d, din, n, h, w = (cfg.d_model, d_inner(cfg), cfg.ssm_state,
                       num_ssm_heads(cfg), cfg.ssm_conv)
    conv_ch = din + 2 * n
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)

    def s(shape, axes, **kw):
        return spec(lead + tuple(shape), lax_ + tuple(axes), **kw)

    return {
        "in_proj": s((d, 2 * din + 2 * n + h), ("embed", "ffn")),
        "conv_w": s((w, conv_ch), ("conv", "ffn"), init="normal", scale=0.5),
        "a_log": s((h,), ("heads",), init="zeros"),
        "d_skip": s((h,), ("heads",), init="ones"),
        "dt_bias": s((h,), ("heads",), init="zeros"),
        "gate_norm": s((din,), ("ffn",), init="ones"),
        "out_proj": s((din, d), ("ffn", "embed")),
    }


def _depthwise_causal_conv(x, w, state=None):
    """x: [B, S, C]; w: [W, C]. Returns (y [B,S,C], new_state [B, W-1, C])."""
    wlen = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], wlen - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)  # [B, S+W-1, C]
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(wlen))
    return y, xp[:, xp.shape[1] - (wlen - 1):, :]


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)), without torch's linear regime above 20."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y, z, w, eps, mean_sq=None):
    """``mean_sq`` (the mean of its argument over the last dim, keepdim):
    ``torch.mean``, or on a heads block the all-reduced sum over ``din``."""
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    dt_ = y.dtype
    y = y.to(torch.float32)
    ms = torch.mean(y * y, dim=-1, keepdim=True) if mean_sq is None \
        else mean_sq(y * y)
    y = y * torch.rsqrt(ms + eps)
    return (y * w.to(torch.float32)).to(dt_)


class _Block(NamedTuple):
    """The part of an SSD layer that one rank runs: heads [h0, h0 + hl)
    (its x and z channels, dt, the SSM state's heads), conv channels
    [c0, c0 + cl), and the collectives over the model axes: ``gather``
    concatenates every model rank's last dim, ``psum`` sums over them.
    :func:`_whole` is one device's: every head and channel, no
    collective."""

    h0: int
    hl: int
    c0: int
    cl: int
    gather: Callable
    psum: Callable
    ranks: int


def _same(t):
    return t


def _whole(cfg: ModelConfig) -> _Block:
    return _Block(0, num_ssm_heads(cfg), 0, d_inner(cfg) + 2 * cfg.ssm_state,
                  _same, _same, 1)


def _front(p, cfg: ModelConfig, x, conv_state, blk: _Block):
    """The in-projection and the conv on ``blk``: (z, xc, B, C, dt,
    new conv state). The projection's columns are gathered over the model
    ranks; the conv runs on the block's channels, its output gathered."""
    din, n, hd = d_inner(cfg), cfg.ssm_state, cfg.ssm_head_dim
    proj = blk.gather(torch.einsum("bsd,dk->bsk", x,
                                   p["in_proj"].to(x.dtype)))
    lo, hi = blk.h0 * hd, (blk.h0 + blk.hl) * hd
    z = proj[..., lo:hi]
    dt0 = 2 * din + 2 * n + blk.h0
    dt = proj[..., dt0:dt0 + blk.hl]
    conv_out, new_conv = _depthwise_causal_conv(
        proj[..., din + blk.c0:din + blk.c0 + blk.cl],
        p["conv_w"].to(x.dtype), conv_state)
    conv_out = blk.gather(F.silu(conv_out))
    return (z, conv_out[..., lo:hi], conv_out[..., din:din + n],
            conv_out[..., din + n:din + 2 * n], dt, new_conv)


def _back(p, cfg: ModelConfig, y, z, blk: _Block, dtype):
    """The gated norm over ``din`` and the out-projection of the block's
    rows of ``out_proj``, summed over the model ranks."""
    mean_sq = None
    if blk.ranks > 1:
        din = d_inner(cfg)

        def mean_sq(sq):
            return blk.psum(torch.sum(sq, dim=-1, keepdim=True)) / din
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps, mean_sq)
    return blk.psum(torch.einsum("bsk,kd->bsd", y,
                                 p["out_proj"].to(dtype)))


def _y_inter(cum_c, ch_c, carry):
    """einsum("blh,bln,bhpn->blhp", exp(cum), C, state), pairwise."""
    cs = torch.einsum("bln,bhpn->blhp", ch_c, carry)
    return torch.exp(cum_c)[..., None] * cs


def ssd_scan_plain(xh, bh, ch, dth, logc, init, out_dtype):
    """The reference's plain scan body, one chunk at a time.

    xh [B, nc, Lc, H, hd]; bh/ch [B, nc, Lc, N] f32; dth/logc
    [B, nc, Lc, H] f32; init [B, H, hd, N] f32. Returns (final state,
    y [B, nc, Lc, H, hd] in ``out_dtype``)."""
    lc = xh.shape[2]
    mask = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=xh.device))
    zero = torch.zeros((), dtype=torch.float32, device=xh.device)
    carry, ys = init, []
    for c in range(xh.shape[1]):
        xh_c, bh_c, ch_c, dth_c, logc_c = (t[:, c] for t in
                                           (xh, bh, ch, dth, logc))
        cum = torch.cumsum(logc_c, dim=1)  # [B, Lc, H]
        total = cum[:, -1, :]  # [B, H]
        xdt = xh_c.to(torch.float32) * dth_c[..., None]  # [B, Lc, H, hd]
        # intra-chunk: G[l,m] = C_l . B_m; M[l,m,h] = exp(cum_l - cum_m), m<=l
        g = torch.einsum("bln,bmn->blm", ch_c, bh_c)
        dlog = cum[:, :, None, :] - cum[:, None, :, :]  # [B, Lc(l), Lc(m), H]
        mexp = torch.where(mask[None, :, :, None], torch.exp(dlog), zero)
        y_intra = torch.einsum("blmh,bmhp->blhp", g[..., None] * mexp, xdt)
        y_inter = _y_inter(cum, ch_c, carry)
        # chunk-local state + recurrence
        w_local = torch.exp(total[:, None, :] - cum)  # [B, Lc, H]
        s_local = torch.einsum("bmhp,bmn->bhpn", w_local[..., None] * xdt,
                               bh_c)
        carry = torch.exp(total)[:, :, None, None] * carry + s_local
        ys.append((y_intra + y_inter).to(out_dtype))
    return carry, torch.stack(ys, dim=1)


def ssd_scan_chunked(chunk_fn: Callable, xh, bh, ch, dth, logc, init,
                     out_dtype):
    """The kernel arrangement: cumsum hoisted, one ``chunk_fn`` call
    (``ssd_chunk`` signature: C/B [G, Lc, N], xdt [G, H, Lc, hd], cum
    [G, H, Lc] -> y [G, H, Lc, hd], s_local [G, H, hd, N]) over the
    (B·nc, H) grid, then the inter-chunk recurrence chunk by chunk.
    Arguments and returns as :func:`ssd_scan_plain`."""
    bsz, nc, lc, h, hd = xh.shape
    n = bh.shape[-1]
    cum = torch.cumsum(logc, dim=2)  # [B, nc, Lc, H]
    total = cum[:, :, -1, :]  # [B, nc, H]
    xdt = xh.to(torch.float32) * dth[..., None]  # [B, nc, Lc, H, hd]
    gdim = bsz * nc
    y_k, s_k = chunk_fn(
        ch.reshape(gdim, lc, n), bh.reshape(gdim, lc, n),
        xdt.permute(0, 1, 3, 2, 4).reshape(gdim, h, lc, hd),
        cum.permute(0, 1, 3, 2).reshape(gdim, h, lc))
    y_intra = y_k.reshape(bsz, nc, h, lc, hd).permute(0, 1, 3, 2, 4)
    s_local = s_k.reshape(bsz, nc, h, hd, n)
    carry, ys = init, []
    for c in range(nc):
        y_inter = _y_inter(cum[:, c], ch[:, c], carry)
        carry = torch.exp(total[:, c])[:, :, None, None] * carry \
            + s_local[:, c]
        ys.append((y_intra[:, c] + y_inter).to(out_dtype))
    return carry, torch.stack(ys, dim=1)


def _on_rows(fn, p, x, *states):
    """``fn(p, x, *states, chunk_fn)`` on this rank's rows of DTensor ``x``
    with the layer's parameters whole (``sharding.on_rows``); the chunk
    function (None for the plain scan) gets this rank's heads block on the
    model axes."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    rows = rows_layout(x)
    pw = {k: whole_for_rows(v, rows) for k, v in p.items()}

    def heads_chunk(c_mat, b_mat, xdt, cum, local_fn):
        """``local_fn`` (a chunk function) on this rank's rows and its
        heads block."""
        from torch.distributed.tensor import Replicate, Shard

        ctx = current_ctx()
        heads = ctx.placements((None, "heads"), tuple(xdt.shape[:2])) \
            if ctx is not None else rows
        cut = tuple(h if isinstance(h, Shard) else Replicate()
                    for h in heads)
        lay = tuple(h if isinstance(h, Shard) else r
                    for r, h in zip(rows, heads))

        def on_mesh(t, placements, narrow=False):
            loc = local_block(t, mesh, cut) if narrow else t
            return DTensor.from_local(loc, mesh, placements, run_check=False)

        y, st = ssd_ops.on_shards(
            local_fn, on_mesh(c_mat, rows), on_mesh(b_mat, rows),
            on_mesh(xdt, lay, True), on_mesh(cum, lay, True))
        return (y.redistribute(mesh, rows).to_local(),
                st.redistribute(mesh, rows).to_local())

    return on_rows(lambda xl, *sl: fn(pw, xl, *sl, heads_chunk), x, *states)


def by_heads(cfg: ModelConfig, tokens: int, ranks: int) -> bool:
    """Whether an SSD layer on a mesh runs by heads (:func:`_by_heads`)
    where a rank holds ``tokens`` tokens and ``ranks`` model ranks split
    the layer: on one model rank always (nothing moves); otherwise where
    the elements a rank moves by heads (the projection and the conv output
    gathered, the [B, S, D] output all-reduced, which moves it twice) are
    fewer than the layer's parameters, which the other layout gathers."""
    if ranks == 1:
        return True
    d, din, n, h, w = (cfg.d_model, d_inner(cfg), cfg.ssm_state,
                       num_ssm_heads(cfg), cfg.ssm_conv)
    moved = tokens * ((2 * din + 2 * n + h) + (din + 2 * n) + 2 * d)
    params = d * (2 * din + 2 * n + h) + w * (din + 2 * n) + din * d \
        + 3 * h + din
    return moved < params


class _Plan(NamedTuple):
    mesh: object
    rows: tuple      # x's row splits, whole over the model dims
    model: tuple     # the mesh dims that split the layer's ffn
    ranks: int


def _heads_plan(p, cfg: ModelConfig, x) -> Optional[_Plan]:
    """The by-heads layout of a layer on ``x``'s mesh, or None where the
    layer keeps its parameters gathered: a parameter that is not a DTensor
    laid out by ``ssd_specs`` over the model dims alone (an FSDP split
    under ``TRAIN_RULES``), or too many tokens a rank (:func:`by_heads`)."""
    from torch.distributed.tensor import Replicate, Shard

    if not all(is_dtensor(v) for v in p.values()):
        return None
    mesh = x.device_mesh
    model = tuple(md for md, pl in enumerate(p["in_proj"].placements)
                  if pl == Shard(1))

    def lay(dim):
        return tuple(Shard(dim) if md in model else Replicate()
                     for md in range(mesh.ndim))

    want = {"in_proj": lay(1), "conv_w": lay(1), "out_proj": lay(0),
            "gate_norm": lay(0), "a_log": lay(0), "d_skip": lay(0),
            "dt_bias": lay(0)}
    if any(tuple(p[k].placements) != v for k, v in want.items()):
        return None
    sizes = tuple(mesh.shape)
    ranks = math.prod(sizes[md] for md in model)
    # the heads must divide the model ranks: a contiguous split of din
    # (gate_norm, out_proj's rows, a rank's x and z channels) is then a
    # split of whole heads. Where they do not, the rule tables' divisibility
    # fallback leaves a_log whole and the layouts above already differ.
    if num_ssm_heads(cfg) % ranks:
        return None
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                 and md not in model else Replicate()
                 for md, pl in enumerate(x.placements))
    row_ways = math.prod(sizes[md] for md, pl in enumerate(rows)
                         if isinstance(pl, Shard))
    tokens = x.shape[0] // row_ways * x.shape[1]
    if not by_heads(cfg, tokens, ranks):
        return None
    return _Plan(mesh, rows, model, ranks)


def _by_heads(fn, p, cfg: ModelConfig, x, conv_state, ssm_state,
              plan: _Plan):
    """``fn(local params, local x, conv block, SSM heads block, _Block)``
    on this rank's rows, its heads and conv channels. The states are taken
    (and come back) as the cache lays them out: the conv state's channels
    and the SSM state's heads on the model dims, neither gathered."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh, rows, model = plan.mesh, plan.rows, plan.model

    def on_model(placement):
        return tuple(placement if md in model else pl
                     for md, pl in enumerate(rows))

    def over_model(placement):
        def move(t):
            return DTensor.from_local(t, mesh, on_model(placement),
                                      run_check=False).redistribute(
                mesh, rows).to_local()
        return move

    h, conv_ch = num_ssm_heads(cfg), d_inner(cfg) + 2 * cfg.ssm_state
    c0, cl = block_range(conv_ch, 1, mesh, p["conv_w"].placements)
    one = plan.ranks == 1
    blk = _Block(block_range(h, 0, mesh, p["a_log"].placements)[0],
                 h // plan.ranks, c0, cl,
                 _same if one else over_model(Shard(2)),
                 _same if one else over_model(Partial()), plan.ranks)
    conv_lay, ssm_lay = on_model(Shard(2)), on_model(Shard(1))
    y, (conv, ssm) = fn({k: v.to_local() for k, v in p.items()},
                        mine(x, mesh, rows),
                        mine(conv_state, mesh, conv_lay),
                        mine(ssm_state, mesh, ssm_lay), blk)
    return (DTensor.from_local(y, mesh, rows, run_check=False),
            (DTensor.from_local(conv, mesh, conv_lay, run_check=False),
             DTensor.from_local(ssm, mesh, ssm_lay, run_check=False)))


def ssd_forward(p, cfg: ModelConfig, x, conv_state=None, ssm_state=None,
                chunk_fn: Optional[Callable] = None):
    """Chunked SSD. x: [B, S, D] -> (y [B, S, D], (conv_state, ssm_state)).

    ``chunk_fn`` forces the kernel arrangement with that chunk function
    (the CPU tests pass the plain ``ssd_chunk_batched_ref``); by default
    ``cfg.use_kernels`` on CUDA tensors picks it with the CUDA kernel."""
    if is_dtensor(x):
        plan = _heads_plan(p, cfg, x)
        if plan is not None:
            return _by_heads(
                lambda pl, xl, cs, ss, blk: _forward(pl, cfg, xl, cs, ss,
                                                     chunk_fn, blk),
                p, cfg, x, conv_state, ssm_state, plan)
        local_fn = chunk_fn
        if chunk_fn is None and cfg.use_kernels and on_cuda(x):
            local_fn = ssd_ops.ssd_chunk

        def run(pw, xl, cs, ss, heads_chunk):
            fn = None
            if local_fn is not None:
                def fn(c, b, xd, cm):
                    return heads_chunk(c, b, xd, cm, local_fn)
            return ssd_forward(pw, cfg, xl, cs, ss, chunk_fn=fn)

        y, states = _on_rows(run, p, x, conv_state, ssm_state)
        return y, states
    return _forward(p, cfg, x, conv_state, ssm_state, chunk_fn, _whole(cfg))


def _forward(p, cfg: ModelConfig, x, conv_state, ssm_state, chunk_fn,
             blk: _Block):
    """:func:`ssd_forward` on plain tensors, the heads of ``blk``."""
    bsz, s, _ = x.shape
    n, h, hd = cfg.ssm_state, blk.hl, cfg.ssm_head_dim
    lc = min(cfg.ssm_chunk, s)
    assert s % lc == 0, (s, lc)
    nc = s // lc
    f32 = torch.float32

    z, xc, b_, c_, dt, new_conv = _front(p, cfg, x, conv_state, blk)
    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["a_log"].to(f32))  # [H]
    loga = dt * a[None, None, :]  # [B, S, H] (log decay, <= 0)

    xh = xc.reshape(bsz, nc, lc, h, hd)
    bh = b_.reshape(bsz, nc, lc, n).to(f32)
    ch = c_.reshape(bsz, nc, lc, n).to(f32)
    dth = dt.reshape(bsz, nc, lc, h)
    logc = loga.reshape(bsz, nc, lc, h)
    init = (torch.zeros((bsz, h, hd, n), dtype=f32, device=x.device)
            if ssm_state is None else ssm_state.to(f32))

    if chunk_fn is None and cfg.use_kernels and on_cuda(x):
        chunk_fn = ssd_ops.ssd_chunk
    if chunk_fn is not None:
        final_state, y = ssd_scan_chunked(chunk_fn, xh, bh, ch, dth, logc,
                                          init, x.dtype)
    else:
        final_state, y = ssd_scan_plain(xh, bh, ch, dth, logc, init, x.dtype)
    y = y.reshape(bsz, s, h, hd).to(f32)
    y = y + xh.reshape(bsz, s, h, hd).to(f32) \
        * p["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(bsz, s, h * hd).to(x.dtype)
    out = _back(p, cfg, y, z, blk, x.dtype)
    return out, (new_conv, final_state.to(f32))


def ssd_decode_step(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """x: [B, 1, D]; O(1) recurrent update, plain as in the reference.
    Returns (y, (conv_state, ssm_state)). The conv state comes back in the
    promoted dtype of (state, x), as ``jnp.concatenate`` gives it: f32
    from a bf16 state and f32 activations. On a mesh by heads, or each
    rank's rows with the parameters and the states whole (:func:`_on_rows`)
    where a rank holds many rows."""
    if is_dtensor(x):
        plan = _heads_plan(p, cfg, x)
        if plan is not None:
            return _by_heads(
                lambda pl, xl, cs, ss, blk: _decode(pl, cfg, xl, cs, ss, blk),
                p, cfg, x, conv_state, ssm_state, plan)
        y, states = _on_rows(
            lambda pw, xl, cs, ss, _: ssd_decode_step(pw, cfg, xl, cs, ss),
            p, x, conv_state, ssm_state)
        return y, states
    return _decode(p, cfg, x, conv_state, ssm_state, _whole(cfg))


def _decode(p, cfg: ModelConfig, x, conv_state, ssm_state, blk: _Block):
    """:func:`ssd_decode_step` on plain tensors, the heads of ``blk``."""
    bsz = x.shape[0]
    h, hd = blk.hl, cfg.ssm_head_dim
    f32 = torch.float32
    z, xc, b_, c_, dt, new_conv = _front(p, cfg, x, conv_state, blk)
    xc = xc[:, 0].reshape(bsz, h, hd)
    b_ = b_[:, 0].to(f32)
    c_ = c_[:, 0].to(f32)

    dt = _softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["a_log"].to(f32))
    decay = torch.exp(dt * a[None, :])  # [B, H]

    xdt = xc.to(f32) * dt[..., None]  # [B, H, hd]
    new_state = decay[:, :, None, None] * ssm_state \
        + torch.einsum("bhp,bn->bhpn", xdt, b_)
    y = torch.einsum("bn,bhpn->bhp", c_, new_state)
    y = y + xc.to(f32) * p["d_skip"].to(f32)[None, :, None]
    y = y.reshape(bsz, 1, h * hd).to(x.dtype)
    return _back(p, cfg, y, z, blk, x.dtype), (new_conv, new_state)


def ssd_state_axes():
    return {
        "conv": ("layers", "batch", "conv", "ffn"),
        "ssm": ("layers", "batch", "heads", None, "state"),
    }


def ssd_state_specs(cfg: ModelConfig, batch, layers: int,
                    dtype=torch.float32):
    """The per-layer decode states as ``(shape, dtype)``: conv bf16, SSM
    in ``dtype``."""
    din, n, h, hd, w = (d_inner(cfg), cfg.ssm_state, num_ssm_heads(cfg),
                        cfg.ssm_head_dim, cfg.ssm_conv)
    return {"conv": ((layers, batch, w - 1, din + 2 * n), torch.bfloat16),
            "ssm": ((layers, batch, h, hd, n), dtype)}


def ssd_init_state(cfg: ModelConfig, batch, layers: int, dtype=torch.float32,
                   device="cuda"):
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt)
            in ssd_state_specs(cfg, batch, layers, dtype).items()}
