"""Model API by config family — port of ``repro.models.api``: the dense
trunk (``dense``, and the VLM, which runs on it), ``moe``, the zamba2
hybrid, xLSTM (``ssm``) and enc-dec (``encdec``, ``audio``), each as an LM
(``forward_train`` and :func:`lm_loss`; ``prefill``, ``decode_step``, its
cache) and as a denoiser trunk (:func:`forward_hidden`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import block_range, is_dtensor, shard_act
from repro_torch.models import dense, encdec, moe, xlstm, zamba2
from repro_torch.models import layers as L
from repro_torch.models.dense import _layers, _positions
from repro_torch.utils import pspec
from repro_torch.utils.tree import requires_grad

_FAMILY = {"dense": dense, "vlm": dense, "moe": moe, "hybrid": zamba2,
           "ssm": xlstm, "encdec": encdec, "audio": encdec}


def get_module(cfg: ModelConfig):
    if cfg.family in _FAMILY:
        return _FAMILY[cfg.family]
    raise NotImplementedError(f"model family {cfg.family!r}: no such "
                              f"family; known: {sorted(_FAMILY)}")


def lm_module(cfg: ModelConfig):
    """The family module's LM entry points (``prefill``, ``decode_step``,
    ``init_cache``)."""
    return get_module(cfg)


def model_specs(cfg: ModelConfig) -> dict:
    return get_module(cfg).specs(cfg)


def param_count(cfg: ModelConfig) -> int:
    return pspec.count_params(model_specs(cfg))


def init_model(cfg: ModelConfig, seed_or_generator=0, device="cuda",
               dtype=None) -> pspec.ParamTree:
    """Random parameters as a :class:`~repro_torch.utils.pspec.ParamTree`
    in ``dtype`` (default ``cfg.param_dtype``), drawn on ``device`` from a
    ``torch.Generator`` or a seed. The draws are not the JAX package's:
    parity tests load its parameters (``load_jax_params``)."""
    dev = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return pspec.ParamTree(pspec.init_params(model_specs(cfg), gen, dtype,
                                             dev))


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.family in ("encdec", "audio")


def lm_loss(params, cfg: ModelConfig, batch: dict, **fw_kwargs):
    """Next-token cross-entropy. ``batch``: {tokens, labels[, src_embeds]}
    tensors, labels -100 = padding (masked). f32 logits, ``logsumexp``,
    the gold logit at ``max(labels, 0)``, and the masked sum over
    ``max(count, 1)``, as the reference. Raises for ``cfg.use_kernels``
    under autograd with parameters that require grad: the kernels have
    no backward (the reference trains with the plain ops)."""
    if cfg.use_kernels and torch.is_grad_enabled() and \
            requires_grad(params):
        raise ValueError(
            "lm_loss: the kernels have no backward (as in the JAX package, "
            "whose training path runs use_kernels=False); train with "
            "cfg.replace(use_kernels=False)")
    mod = get_module(cfg)
    tokens = batch["tokens"]
    if is_encdec(cfg):
        logits = mod.forward_train(params, cfg, tokens, batch["src_embeds"],
                                   **fw_kwargs)
    else:
        logits = mod.forward_train(params, cfg, tokens, **fw_kwargs)
    labels = batch["labels"]
    logits = shard_act(logits, ("batch", "seq", "vocab")).to(torch.float32)
    if is_dtensor(logits):
        logz, gold = _vocab_parallel_logz_gold(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp_min(
            labels, 0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


class _BlockLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of this rank's vocab block ``x``, the
    blocks' maxima and sums reduced by ``reduce(t, op)``. The forward is
    ``torch.logsumexp``'s formula (the max, an infinite max taken as 0,
    the log of the sum of the exps of the differences, plus the max) and
    the backward its own, ``grad * exp(x - logz)`` on the block, so where
    no mesh dim of more than one rank splits the vocab both are its
    bits."""

    @staticmethod
    def forward(ctx, x, reduce):
        m = reduce(torch.amax(x, dim=-1), "max")
        m = torch.where(torch.abs(m) == math.inf, torch.zeros_like(m), m)
        s = reduce(torch.sum(torch.exp(x - m[..., None]), dim=-1), "sum")
        logz = torch.log(s) + m
        ctx.save_for_backward(x, logz)
        return logz

    @staticmethod
    def backward(ctx, grad):
        x, logz = ctx.saved_tensors
        return grad[..., None] * torch.exp(x - logz[..., None]), None


def _vocab_parallel_logz_gold(logits, labels):
    """(logsumexp over the vocab, the logit at ``max(labels, 0)``) of f32
    DTensor logits [B, S, V], as DTensors [B, S] laid out like the logits'
    rows. Each rank reduces the vocab block it holds; the blocks' maxima,
    sums and gold picks are then reduced over the mesh dims that split the
    vocab (three all-reduces of [B, S] rows, never the [B, S, V] logits):
    the vocab-parallel cross-entropy. DTensor's own ``logsumexp`` and
    ``gather`` would gather the vocab, or fail: its gather over a sharded
    dim gives a mask-partial that the next op cannot reduce. Where no mesh
    dim of more than one rank splits the vocab, the values and gradients
    are the bits of ``torch.logsumexp`` and ``torch.gather``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = logits.device_mesh
    last = logits.dim() - 1
    vocab = [isinstance(p, Shard) and p.dim == last
             for p in logits.placements]
    lay = [Replicate() if v else p for v, p in zip(vocab, logits.placements)]
    if tuple(labels.placements) != tuple(lay):
        labels = labels.redistribute(mesh, lay)

    def over_vocab(t, op):
        part = [Partial(op) if v else p for v, p in zip(vocab, lay)]
        return DTensor.from_local(t, mesh, part,
                                  run_check=False).redistribute(mesh, lay)

    x = logits.to_local()
    logz = _BlockLogSumExp.apply(
        x, lambda t, op: over_vocab(t, op).to_local())
    start, n = block_range(logits.shape[last], last, mesh, logits.placements)
    idx = torch.clamp_min(labels.to_local(), 0).long() - start
    held = (idx >= 0) & (idx < n)
    g = torch.gather(x, -1, torch.where(held, idx, 0)[..., None])[..., 0]
    gold = over_vocab(torch.where(held, g, torch.zeros_like(g)), "sum")
    return DTensor.from_local(logz, mesh, lay, run_check=False), gold


def forward_hidden(params, cfg: ModelConfig, embeds, **kw):
    """Backbone as a denoiser trunk: embeds in, hidden out (non-causal for
    the dense trunk). The recurrent trunks (hybrid, xLSTM) are causal-only,
    so, as in the reference, they run causally whatever ``causal`` the
    caller passes. Enc-dec runs its decoder stack (causal self-attention,
    cross-attention into ``memory``, zeros [B, 16, D] by default) and a
    final norm on the kernel route."""
    if is_encdec(cfg):
        memory = kw.pop("memory", None)
        b, s = embeds.shape[:2]
        if memory is None:
            memory = torch.zeros((b, 16, cfg.d_model), dtype=embeds.dtype,
                                 device=embeds.device)
        pos = _positions(cfg, b, s, device=embeds.device)
        mem_pos = _positions(cfg, b, memory.shape[1], device=embeds.device)
        h = embeds
        for p in _layers(params["dec"]):
            h = encdec._dec_block(cfg, p, h, memory, pos, mem_pos,
                                  kw.get("attn_impl", "auto"))
        return L.rmsnorm(h, params["final_norm"], cfg.norm_eps,
                         use_kernel=cfg.use_kernels)
    if cfg.family in ("hybrid", "ssm"):
        kw["causal"] = True
    return get_module(cfg).forward_hidden(params, cfg, embeds, **kw)
