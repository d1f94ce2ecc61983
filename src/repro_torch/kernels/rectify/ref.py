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


def accept_sums_in_kernel_order(out, prev, cluster: int, span: int,
                                threads: int, vec: int):
    """The accept sums of ``fused_step_rectify_accept`` added in the CUDA
    kernel's order (``csrc/rectify.cu``) for one launch plan
    (``kernel.accept_plan``), on any device: each row's cluster block b
    takes columns [b*span, (b+1)*span), its thread t the ``vec``-wide pieces
    t, t + threads, ... in turn; then each warp's 32 partials by the
    shuffle-down tree, the block's warp partials by the same tree, and the
    ``cluster`` block partials in rank order. Every step is one f32
    rounding, so on the card the kernel's sums equal these bitwise.
    out: [R, M] (the update), prev: [P, M]. Returns (err_sq [R], out_sq [R]).
    """
    rows, m = out.shape
    p = prev.shape[0]
    prev_r = prev.repeat_interleave(rows // p, dim=0) if p != rows else prev
    e = out - prev_r
    terms = torch.stack((e * e, out * out))              # [2, R, M]
    # zeros after each thread's last term add nothing (x + 0 == x)
    pieces = span // vec
    iters = -(-pieces // threads)
    terms = torch.nn.functional.pad(terms, (0, cluster * span - m))
    terms = terms.reshape(2, rows, cluster, pieces, vec)
    terms = torch.nn.functional.pad(terms,
                                    (0, 0, 0, iters * threads - pieces))
    terms = terms.reshape(2, rows, cluster, iters, threads, vec)
    acc = torch.zeros(2, rows, cluster, threads, dtype=out.dtype,
                      device=out.device)
    for i in range(iters):
        for j in range(vec):
            acc = acc + terms[..., i, :, j]
    warps = _warp_tree(acc.reshape(2, rows, cluster, threads // 32, 32))
    block = _warp_tree(torch.nn.functional.pad(warps,
                                               (0, 32 - threads // 32)))
    sums = block[..., 0]
    for r in range(1, cluster):
        sums = sums + block[..., r]
    return sums[0], sums[1]


def _warp_tree(v):
    """Lane 0 of ``__shfl_down_sync`` sums over the last dim (32 lanes):
    at offset o, lane l < o adds lane l + o."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]
