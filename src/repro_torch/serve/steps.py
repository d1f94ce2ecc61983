"""LM serving steps (prefill / decode) — port of ``repro.serve.steps``:
per-family dispatch for the generation example, greedy sampling
included."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as model_api


def make_prefill(cfg: ModelConfig, max_len: int, attn_impl: str = "chunked",
                 **kw):
    """``prefill(params, tokens) -> (logits, cache)`` with a cache of
    ``max_len`` positions; enc-dec's takes the source frames too,
    ``prefill(params, tokens, src_embeds)``, and xLSTM's recurrent state
    has no length."""
    mod = model_api.lm_module(cfg)

    if model_api.is_encdec(cfg):
        def prefill(params, tokens, src_embeds):
            return mod.prefill(params, cfg, tokens, max_len, src_embeds,
                               attn_impl=attn_impl)
        return prefill

    if cfg.family == "ssm":
        def prefill(params, tokens):
            return mod.prefill(params, cfg, tokens)
        return prefill

    def prefill(params, tokens):
        return mod.prefill(params, cfg, tokens, max_len, attn_impl=attn_impl,
                           **kw)

    return prefill


def make_decode_step(cfg: ModelConfig, **kw):
    """``decode(params, tokens [B, 1], cache) -> (logits, cache)``; the
    cache is updated in place."""
    mod = model_api.lm_module(cfg)

    def decode(params, tokens, cache):
        return mod.decode_step(params, cfg, tokens, cache, **kw)

    return decode


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
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    outs = [prompt.to(torch.int32), tok]
    for _ in range(steps - 1):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)
