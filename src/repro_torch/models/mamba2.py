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

On a mesh (DTensor activations under ``use_sharding``) a layer runs on each
rank's rows with its parameters whole (:func:`_on_rows`): the in-projection
packs z, x, B, C and dt along one ``ffn`` dim, whose split over the model
axes does not follow the heads, so the port does not split the layer's
products. The kernel arrangement's ``ssd_chunk`` runs on those rows and
this rank's block of heads over the model axes (``kernels/ssd_scan/ops.py``
on DTensors), its outputs gathered back over them. The states come back
laid out as the rows; a cache writes its own block of them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (current_ctx, is_dtensor, local_block,
                                       shard_act, whole)
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


def _split(cfg, proj):
    din, n = d_inner(cfg), cfg.ssm_state
    z = proj[..., :din]
    xc = proj[..., din:2 * din]
    b_ = proj[..., 2 * din:2 * din + n]
    c_ = proj[..., 2 * din + n:2 * din + 2 * n]
    dt = proj[..., 2 * din + 2 * n:]
    return z, xc, b_, c_, dt


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)), without torch's linear regime above 20."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y, z, w, eps):
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    dt_ = y.dtype
    y = y.to(torch.float32)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt_)


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


def _rows_layout(x):
    """``x``'s placements with only its dim-0 (rows) splits kept."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def _on_rows(fn, p, x, *states):
    """``fn(p, x, *states, chunk_fn)`` on this rank's rows of DTensor
    ``x`` with the layer's parameters whole; the chunk function (None for
    the plain scan) gets this rank's heads block on the model axes. The
    outputs come back as DTensors laid out as the rows."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    rows = _rows_layout(x)

    def mine(t):
        if t is None or not is_dtensor(t):
            return t
        if tuple(t.placements) != rows:
            t = t.redistribute(mesh, rows)
        return t.to_local()

    pw = {k: whole(v) for k, v in p.items()}

    def y_rows(t):
        return DTensor.from_local(t, mesh, rows, run_check=False)

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

    y, (conv, ssm) = fn(pw, mine(x), *(mine(t) for t in states),
                        heads_chunk)
    return y_rows(y), (y_rows(conv), y_rows(ssm))


def ssd_forward(p, cfg: ModelConfig, x, conv_state=None, ssm_state=None,
                chunk_fn: Optional[Callable] = None):
    """Chunked SSD. x: [B, S, D] -> (y [B, S, D], (conv_state, ssm_state)).

    ``chunk_fn`` forces the kernel arrangement with that chunk function
    (the CPU tests pass the plain ``ssd_chunk_batched_ref``); by default
    ``cfg.use_kernels`` on CUDA tensors picks it with the CUDA kernel."""
    if is_dtensor(x):
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
    bsz, s, _ = x.shape
    din, n, h, hd = (d_inner(cfg), cfg.ssm_state, num_ssm_heads(cfg),
                     cfg.ssm_head_dim)
    lc = min(cfg.ssm_chunk, s)
    assert s % lc == 0, (s, lc)
    nc = s // lc
    f32 = torch.float32

    proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"].to(x.dtype))
    z, xc, b_, c_, dt = _split(cfg, proj)
    conv_in = torch.cat([xc, b_, c_], dim=-1)
    conv_out, new_conv = _depthwise_causal_conv(conv_in,
                                                p["conv_w"].to(x.dtype),
                                                conv_state)
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :din]
    b_ = conv_out[..., din:din + n]
    c_ = conv_out[..., din + n:]

    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["a_log"].to(f32))  # [H]
    loga = dt * a[None, None, :]  # [B, S, H] (log decay, <= 0)

    xh = shard_act(xc.reshape(bsz, nc, lc, h, hd),
                   ("batch", None, None, "heads", None))
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
    y = y.reshape(bsz, s, din).to(x.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"].to(x.dtype))
    return out, (new_conv, final_state.to(f32))


def ssd_decode_step(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """x: [B, 1, D]; O(1) recurrent update, plain as in the reference.
    Returns (y, (conv_state, ssm_state)). The conv state comes back in the
    promoted dtype of (state, x), as ``jnp.concatenate`` gives it: f32
    from a bf16 state and f32 activations. On a mesh each rank's rows,
    the parameters and the states whole (:func:`_on_rows`)."""
    if is_dtensor(x):
        y, states = _on_rows(
            lambda pw, xl, cs, ss, _: ssd_decode_step(pw, cfg, xl, cs, ss),
            p, x, conv_state, ssm_state)
        return y, states
    bsz = x.shape[0]
    din, n, h, hd = (d_inner(cfg), cfg.ssm_state, num_ssm_heads(cfg),
                     cfg.ssm_head_dim)
    f32 = torch.float32
    proj = torch.einsum("bsd,dk->bsk", x, p["in_proj"].to(x.dtype))
    z, xc, b_, c_, dt = _split(cfg, proj)
    conv_in = torch.cat([xc, b_, c_], dim=-1)  # [B, 1, C]
    conv_out, new_conv = _depthwise_causal_conv(conv_in,
                                                p["conv_w"].to(x.dtype),
                                                conv_state)
    conv_out = F.silu(conv_out)[:, 0]  # [B, C]
    xc = conv_out[..., :din].reshape(bsz, h, hd)
    b_ = conv_out[..., din:din + n].to(f32)
    c_ = conv_out[..., din + n:].to(f32)

    dt = _softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["a_log"].to(f32))
    decay = torch.exp(dt * a[None, :])  # [B, H]

    xdt = xc.to(f32) * dt[..., None]  # [B, H, hd]
    new_state = decay[:, :, None, None] * ssm_state \
        + torch.einsum("bhp,bn->bhpn", xdt, b_)
    y = torch.einsum("bn,bhpn->bhp", c_, new_state)
    y = y + xc.to(f32) * p["d_skip"].to(f32)[None, :, None]
    y = y.reshape(bsz, 1, din).to(x.dtype)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"].to(x.dtype))
    return out, (new_conv, new_state)


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
