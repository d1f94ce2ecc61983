"""Dispatcher for the fused step+rectify(+accept) update.

``use_kernel=True`` launches the CUDA kernel for CUDA tensors and runs the
plain version (``ref.py``) for CPU tensors — the plain version *is* the
kernel's float semantics, so flipping ``use_kernel`` on the CPU never
changes a bit. ``use_kernel=False`` always runs the plain version. A kernel
that fails to build or launch raises; there is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels import on_cuda
from repro_torch.kernels.rectify import kernel
from repro_torch.kernels.rectify.ref import (fused_step_rectify_accept_ref,
                                             fused_step_rectify_ref)


def _flat(t, rows):
    return t.reshape(rows, -1)


def step_rectify(x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire,
                 use_kernel: bool = True):
    """Latents [R, ...] (flattened internally), dt/dsnap/fire [R]."""
    rows, shape = x.shape[0], x.shape
    args = [_flat(a, rows) for a in (x, f, x_up, f_up, x_snap, f_snap)]
    if use_kernel and on_cuda(x):
        out = kernel.fused_step_rectify(*[a.contiguous() for a in args],
                                        dt.contiguous(), dsnap.contiguous(),
                                        fire)
    else:
        out = fused_step_rectify_ref(*args, dt, dsnap, fire)
    return out.reshape(shape)


def step_rectify_accept(x, f, x_up, f_up, x_snap, f_snap, prev,
                        dt, dsnap, fire, use_kernel: bool = True):
    """Latents [R, ...], prev [P, ...] (R divisible by P; see ``ref.py``).
    Returns (x_new [R, ...], err_sq [R], out_sq [R])."""
    rows, shape = x.shape[0], x.shape
    args = [_flat(a, rows) for a in (x, f, x_up, f_up, x_snap, f_snap)]
    prev2 = prev.reshape(prev.shape[0], -1)
    if use_kernel and on_cuda(x):
        out, err_sq, out_sq = kernel.fused_step_rectify_accept(
            *[a.contiguous() for a in args], prev2.contiguous(),
            dt.contiguous(), dsnap.contiguous(), fire)
    else:
        out, err_sq, out_sq = fused_step_rectify_accept_ref(
            *args, prev2, dt, dsnap, fire)
    return out.reshape(shape), err_sq, out_sq
