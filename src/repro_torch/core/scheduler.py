"""Discrete scheduler (paper Eq. 7) as pure index math — port of
``repro.core.scheduler``.

Lockstep round r (1-based), core k0 (0-based), init sequence i[0..K-1]:

  jump phase  (r <= k0):  cur = i[r-1],            next = i[r]
  fine phase  (r >  k0):  cur = i[k0] + r - k0 - 1, next = cur + 1

Core k0 emits its output at round N - i[k0] + k0. ``positions`` also takes
leading slot dims (``i_arr`` [..., K] with ``r`` [...]), which is what lets
the slot grid advance every slot's own round counter in one call.
"""
from __future__ import annotations

import numpy as np
import torch


def positions(i_arr: torch.Tensor, r):
    """i_arr: [..., K] int; r: round(s), scalar or [...] (1-based).

    Returns (cur, nxt): [..., K] int32 each.
    """
    kk = i_arr.shape[-1]
    kmax = kk - 1
    r = torch.as_tensor(r, device=i_arr.device)
    i64 = i_arr.to(torch.int64)
    r = r.to(torch.int64)[..., None]                       # [..., 1]
    k0 = torch.arange(kk, device=i_arr.device)
    jump = r <= k0
    lead = tuple(np.broadcast_shapes(tuple(i64.shape[:-1]),
                                     tuple(r.shape[:-1])))
    i64 = i64.expand(lead + (kk,))
    r = r.expand(lead + (1,))

    def at(idx):
        return torch.gather(i64, -1, idx.clamp(max=kmax).expand(lead + (kk,)))

    cur = torch.where(jump, at(r - 1), i64 + r - k0 - 1)
    nxt = torch.where(jump, at(r), cur + 1)
    return cur.to(torch.int32), nxt.to(torch.int32)


def positions_np(i_seq, r):
    """NumPy twin of ``positions`` (for tests / host-side planning)."""
    i_arr = np.asarray(i_seq)
    k0 = np.arange(len(i_seq))
    jump = r <= k0
    cur = np.where(jump, i_arr[np.minimum(r - 1, len(i_seq) - 1)],
                   i_arr + r - k0 - 1)
    nxt = np.where(jump, i_arr[np.minimum(r, len(i_seq) - 1)], cur + 1)
    return cur, nxt


def emit_rounds(i_seq, n_steps):
    """Round (1-based) at which each core emits its output."""
    k0 = np.arange(len(i_seq))
    return n_steps - np.asarray(i_seq) + k0


def emit_rounds_t(i_arr: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Tensor twin of ``emit_rounds``; ``i_arr`` may carry leading slot dims
    ([..., K])."""
    k0 = torch.arange(i_arr.shape[-1], device=i_arr.device,
                      dtype=i_arr.dtype)
    return n_steps - i_arr + k0
