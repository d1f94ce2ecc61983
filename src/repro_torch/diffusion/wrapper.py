"""Diffusion wrapper: the backbone as a drift f_theta(x, t) — port of
``repro.diffusion.wrapper``.

Latent-sequence denoiser: in-proj latent -> d_model, sinusoidal time
embedding (MLP'd) added to every position, backbone run non-causally, RMS
output norm and out-proj back to the latent dim (velocity prediction under
rectified flow). The time embedding, ``t_mlp*``, the output norm and
``out_proj`` run in f32; the backbone in ``cfg.compute_dtype``.

``make_drift`` returns the port's row drift (``repro_torch.core.ode``):
``drift(x [R, *latent], t [R])`` with latent ``(..., S, L)`` flattens every
row's batch into one ``[rows, S, L]`` backbone call with a per-row time —
one call per CHORDS round for the whole slot x core grid.

The f32 products whose row count follows the grid run in fixed pieces of
rows (:func:`row_product`): the out-projection in pieces of
:data:`OUT_PIECE_ROWS` token rows (:func:`out_project`) and the time MLP's
two products in pieces of :data:`TIME_PIECE_ROWS` samples. The card's f32
GEMM is chosen by shape, so one product over all rows gave a row other
bits in a grid of 2 or 4 slots than alone (the time MLP at 16 samples
against 8 or 32 on the H100; one ulp of the time embedding then flips
bf16 roundings downstream), and the engines' bitwise contracts (overlap
against sync, elastic against a fixed grid) failed for requests that ran
rounds at another grid size. Every piece has one shape, so a row's bits
do not depend on how many rows share the call. On a mesh (DTensor rows,
split over the slots' or cores' mesh axes) the pieces are cut from each
rank's own rows (``kernels/mesh.py::local_shards``): slicing and joining
the global rows would gather them, and a row's bits do not depend on its
neighbours, so the result is the one-device result.

Training: :func:`diffusion_loss` is the rectified-flow loss, drawing its
times and noise from a ``torch.Generator``; :func:`diffusion_loss_from`
takes them as tensors (the JAX package's draws cannot be replayed in
torch, so the parity tests feed both the same numbers). The loss runs the
plain ops: the kernels have no backward, as in the JAX package, and a loss
asked for them under autograd raises.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import mesh as kmesh
from repro_torch.models import api as model_api
from repro_torch.utils.pspec import ParamTree, init_params, spec
from repro_torch.utils.tree import requires_grad


def wrapper_specs(cfg: ModelConfig, latent_dim: int) -> dict:
    d = cfg.d_model
    return {
        "backbone": model_api.model_specs(cfg),
        "in_proj": spec((latent_dim, d), (None, "embed")),
        "t_mlp1": spec((256, d), (None, "embed")),
        "t_mlp2": spec((d, d), ("embed", "embed_act")),
        "out_norm": spec((d,), (None,), init="ones"),
        "out_proj": spec((d, latent_dim), ("embed", None), init="zeros"),
    }


def init_wrapper(cfg: ModelConfig, latent_dim: int,
                 generator: torch.Generator = None, dtype=torch.float32,
                 device="cuda") -> ParamTree:
    """Random wrapper parameters as a :class:`ParamTree`.

    The backbone is stored in ``cfg.param_dtype`` (bf16 for
    ``chords-dit-xl``: ~10.9 GB instead of 21.8 GB) and the wrapper head in
    ``dtype`` (f32). The JAX launcher keeps f32 weights and casts them per
    use; casting once at init computes the same numbers, since every use
    casts to the same compute dtype. ``generator`` defaults to seed 0 on
    ``device``.
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    specs = wrapper_specs(cfg, latent_dim)
    backbone = specs.pop("backbone")
    tree = init_params(specs, gen, dtype, dev)
    tree["backbone"] = init_params(backbone, gen,
                                   getattr(torch, cfg.param_dtype), dev)
    return ParamTree(tree)


def time_embedding(t, dim=256, max_period=1e4):
    """t: scalar or [B] in [0, 1] -> [..., dim] sinusoidal features."""
    t = torch.as_tensor(t, dtype=torch.float32) * 1000.0
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


OUT_PIECE_ROWS = 512  # token rows a piece of the out-projection (one slot
                      # of K=8 cores at 64 tokens)
TIME_PIECE_ROWS = 8   # samples a piece of the time MLP's products


def row_product(x, w, piece_rows: int):
    """``x [..., k] @ w [k, n]`` over the flattened rows of ``x`` in pieces
    of ``piece_rows`` rows, the last one padded with zero rows, so every
    GEMM has the same shape and a row's bits do not depend on the rows
    beside it (the card's f32 GEMM is chosen by shape). The pieces are
    joined by ``cat``, so it differentiates. A DTensor ``x`` runs on each
    rank's rows, the contracted dim whole."""
    if is_dtensor(x):
        return kmesh.local_shards(
            "row_product", lambda a, b: row_product(a, b, piece_rows),
            (x, w), whole=((-1,), (0, 1)))
    k = x.shape[-1]
    x2 = x.reshape(-1, k)
    n = x2.shape[0]
    pad = (-n) % piece_rows
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(pad, k)])
    out = torch.cat([x2[i:i + piece_rows] @ w
                     for i in range(0, x2.shape[0], piece_rows)])
    return out[:n].reshape(x.shape[:-1] + (w.shape[-1],))


def out_project(hf, w):
    """The f32 out-projection ``einsum("bsd,dl->bsl", hf, w)`` in pieces of
    :data:`OUT_PIECE_ROWS` token rows (:func:`row_product`)."""
    return row_product(hf, w, OUT_PIECE_ROWS)


def _time_mlp(t, w1, w2):
    """t: scalar or [B] -> the time embedding's MLP features [(B,) d]."""
    te = time_embedding(t)  # [256]/[B,256]
    te = F.silu(row_product(te, w1, TIME_PIECE_ROWS))
    return row_product(te, w2, TIME_PIECE_ROWS)


def denoise(params, cfg: ModelConfig, x, t):
    """x: [B, S, latent_dim]; t: scalar or [B] in [0, 1] (per-row times).
    Returns the velocity [B, S, latent_dim] in x's dtype."""
    dt_ = getattr(torch, cfg.compute_dtype)
    f32 = torch.float32
    h = torch.einsum("bsl,ld->bsd", x.to(dt_), params["in_proj"].to(dt_))
    w1, w2 = params["t_mlp1"].to(f32), params["t_mlp2"].to(f32)
    if is_dtensor(t):  # per-row times on a mesh: each rank's rows
        te = kmesh.local_shards("time_mlp", _time_mlp, (t, w1, w2),
                                whole=((), (0, 1), (0, 1)))
    else:
        te = _time_mlp(torch.as_tensor(t, device=x.device), w1, w2)
    if te.ndim == 2:
        te = te[:, None, :]
    h = h + te.to(dt_)
    h = model_api.forward_hidden(params["backbone"], cfg, h, causal=False)
    hf = h.to(f32)
    hf = hf * torch.rsqrt(torch.mean(hf * hf, -1, keepdim=True)
                          + cfg.norm_eps)
    hf = hf * params["out_norm"].to(f32)
    return out_project(hf, params["out_proj"].to(f32)).to(x.dtype)


def make_drift(params, cfg: ModelConfig):
    """Row drift for the port's samplers: x [R, ..., S, L], t [R]."""

    def drift(x, t):
        rows = x.shape[0]
        xf = x.reshape((-1,) + x.shape[-2:])
        per_row = xf.shape[0] // rows
        tf = t.reshape(rows, 1).expand(rows, per_row).reshape(-1)
        return denoise(params, cfg, xf, tf).reshape(x.shape)

    return drift


def _denoise_batch_t(params, cfg: ModelConfig, x, t_vec):
    """Per-sample times (training): x [B, S, L], t_vec [B]. The port's
    :func:`denoise` already takes a time per row, so this is that call (the
    reference keeps a separate copy for its vector ``t``)."""
    return denoise(params, cfg, x, t_vec)


def diffusion_loss_from(params, cfg: ModelConfig, x1, t, eps):
    """Rectified-flow loss ``mean ||v(x_t, t) - (x1 - eps)||^2`` for given
    times ``t`` [B, 1, 1] and noise ``eps`` (x1's shape), with
    ``x_t = (1 - t) eps + t x1``. Raises for ``cfg.use_kernels`` under
    autograd: the kernels have no backward."""
    if cfg.use_kernels and torch.is_grad_enabled() and requires_grad(params):
        raise ValueError(
            "diffusion_loss: the kernels have no backward (as in the JAX "
            "package, whose training path runs use_kernels=False); train "
            "with cfg.replace(use_kernels=False)")
    x_t = (1.0 - t) * eps + t * x1
    v = _denoise_batch_t(params, cfg, x_t, t[:, 0, 0])
    target = x1 - eps
    return torch.mean((v.to(torch.float32) - target.to(torch.float32)) ** 2)


def diffusion_loss(params, cfg: ModelConfig, x1,
                   generator: torch.Generator):
    """Rectified-flow training loss with ``t ~ U(0, 1)`` per sample and
    ``eps ~ N(0, I)`` drawn from ``generator`` (on x1's device)."""
    b = x1.shape[0]
    t = torch.rand((b, 1, 1), generator=generator, device=x1.device)
    eps = torch.randn(x1.shape, generator=generator, device=x1.device,
                      dtype=x1.dtype)
    return diffusion_loss_from(params, cfg, x1, t, eps)
