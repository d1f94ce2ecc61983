"""Plain PyTorch attention, op for op ``repro.kernels.flash_attention.ref``
(q pre-scaled in f32, masked logits at -1e30, softmax, f32 PV product)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def masked_attention(q, k, v, mask: Optional[torch.Tensor],
                     scale: Optional[float] = None):
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, KV, Dh]; mask broadcastable to
    [B, KV, G, Sq, Sk] (True = attend) or None. GQA by head grouping."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kvh, g, dh).to(torch.float32) * scale
    logits = torch.einsum("bqhgk,bshk->bhgqs", qg, k.to(torch.float32))
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqs,bshk->bqhgk", w, v.to(torch.float32))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attention_ref(q, k, v, causal: bool, scale: Optional[float] = None):
    mask = None
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    return masked_attention(q, k, v, mask, scale)
