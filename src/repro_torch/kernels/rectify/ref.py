"""Plain PyTorch version of the fused CHORDS step+rectify update.

Mirrors ``repro.kernels.rectify.ref`` op for op; the rectification term is
literally :func:`repro_torch.core.rectify.rectify_delta`. Each op rounds on
its own, and the CUDA kernel (``csrc/rectify.cu``) reproduces that rounding
with explicit ``__f*_rn`` intrinsics, so on the card ``out`` is bitwise equal
to this function.
"""
from __future__ import annotations

import torch

from repro_torch.core.rectify import rectify_delta


def fused_step_rectify_ref(x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire):
    """x/f/x_up/f_up/x_snap/f_snap: [R, M]; dt, dsnap: [R]; fire: [R] bool.
    Returns ``x + (dt*f + where(fire, rect, 0))``."""
    delta = dt[:, None] * f
    rect = rectify_delta(x_up, f_up, x_snap, f_snap, dsnap[:, None])
    return x + (delta + torch.where(fire[:, None], rect,
                                    torch.zeros((), dtype=rect.dtype,
                                                device=rect.device)))


def fused_step_rectify_accept_ref(x, f, x_up, f_up, x_snap, f_snap, prev,
                                  dt, dsnap, fire):
    """The update plus the accept sums of ``core.chords.accept_test``.

    prev: [P, M] with R divisible by P; row r is compared against
    ``prev[r // (R // P)]`` (P = S slots for an [S*K, M] grid, P = R for a
    per-row prev). Returns (out [R, M], err_sq [R], out_sq [R]).
    """
    out = fused_step_rectify_ref(x, f, x_up, f_up, x_snap, f_snap,
                                 dt, dsnap, fire)
    rows, p = x.shape[0], prev.shape[0]
    prev_r = prev.repeat_interleave(rows // p, dim=0) if p != rows else prev
    err_sq = torch.sum((out - prev_r) ** 2, dim=1)
    out_sq = torch.sum(out * out, dim=1)
    return out, err_sq, out_sq
