"""LM serving steps (prefill / decode) — port of ``repro.serve.steps``:
per-family dispatch for the generation example, greedy sampling
included.

On a mesh: called inside ``use_sharding(mesh, SERVE_RULES)`` with the
parameters laid out by ``dist.sharding.distribute_tree``, a step lays its
token (and source-frame) arrays out ``("batch", ...)`` (each rank keeps
its rows of the global arrays every rank holds), takes the model's plain
constants as replicated, and the models lay the new cache out by their
``cache_axes``. Logits come back as DTensors; ``greedy_generate`` reads
each step's last-position logits whole to pick the next tokens.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import current_ctx, is_dtensor, local_dtensor
from repro_torch.models import api as model_api
from repro_torch.utils.tree import tree_leaves


@contextlib.contextmanager
def _on_mesh(params):
    """The ambient context when ``params`` lives on its mesh (DTensors),
    with the model's plain constants taken as replicated; else None."""
    ctx = current_ctx()
    leaves = tree_leaves(params)
    if ctx is None or not leaves or not is_dtensor(leaves[0]):
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield ctx


def _rows(t, ctx):
    """A global array (the same on every rank) laid out batch-first."""
    if ctx is None or is_dtensor(t):
        return t
    return local_dtensor(t, ctx.mesh, ctx.placements(
        ("batch",) + (None,) * (t.dim() - 1), tuple(t.shape)))


def make_prefill(cfg: ModelConfig, max_len: int, attn_impl: str = "chunked",
                 **kw):
    """``prefill(params, tokens) -> (logits, cache)`` with a cache of
    ``max_len`` positions; enc-dec's takes the source frames too,
    ``prefill(params, tokens, src_embeds)``, and xLSTM's recurrent state
    has no length."""
    mod = model_api.lm_module(cfg)

    if model_api.is_encdec(cfg):
        def prefill(params, tokens, src_embeds):
            with _on_mesh(params) as ctx:
                return mod.prefill(params, cfg, _rows(tokens, ctx), max_len,
                                   _rows(src_embeds, ctx),
                                   attn_impl=attn_impl)
        return prefill

    if cfg.family == "ssm":
        def prefill(params, tokens):
            with _on_mesh(params) as ctx:
                return mod.prefill(params, cfg, _rows(tokens, ctx))
        return prefill

    def prefill(params, tokens):
        with _on_mesh(params) as ctx:
            return mod.prefill(params, cfg, _rows(tokens, ctx), max_len,
                               attn_impl=attn_impl, **kw)

    return prefill


def make_decode_step(cfg: ModelConfig, **kw):
    """``decode(params, tokens [B, 1], cache) -> (logits, cache)``; the
    cache is updated in place."""
    mod = model_api.lm_module(cfg)

    def decode(params, tokens, cache):
        with _on_mesh(params) as ctx:
            return mod.decode_step(params, cfg, _rows(tokens, ctx), cache,
                                   **kw)

    return decode


def _last_tokens(logits):
    """Greedy tokens of the last position [B, 1] (int32); a DTensor's
    logits are read whole (the vocab may be split)."""
    last = logits[:, -1:]
    if is_dtensor(last):
        last = last.full_tensor()
    return torch.argmax(last, dim=-1).to(torch.int32)


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, prompt, steps: int,
                    max_len: int, **kw):
    """prompt: [B, S0] int -> [B, S0 + steps] greedy tokens (int32). The
    KV cache is a carry that each decode step updates in place; the loop
    does not wait for the device between steps. Enc-dec is not taken, as
    in the reference: its prefill needs the source frames."""
    if model_api.is_encdec(cfg):
        raise ValueError(f"greedy_generate: {cfg.name} is enc-dec; prefill "
                         f"with make_prefill(cfg, max_len)(params, tokens, "
                         f"src_embeds) and decode step by step")
    prefill = make_prefill(cfg, max_len, **kw)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, prompt)
    tok = _last_tokens(logits)
    outs = [prompt.to(torch.int32), tok]
    for _ in range(steps - 1):
        logits, cache = decode(params, tok, cache)
        tok = _last_tokens(logits)
        outs.append(tok)
    return torch.cat(outs, dim=1)
