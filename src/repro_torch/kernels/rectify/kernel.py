"""ctypes binding of the fused step+rectify(+accept) CUDA kernels.

Replaces the Pallas TPU kernels ``fused_step_rectify`` and
``fused_step_rectify_accept`` (``src/repro/kernels/rectify/kernel.py``);
the source is ``src/repro_torch/csrc/rectify.cu``. Bound on the card: bytes
(six or seven f32 latent reads and one write per element), so one launch
covers the whole [S*K, M] grid with per-row scalars, and the accept sums
are reduced in the same pass (block partials, then a second fixed-order
pass: deterministic, no atomics).

These wrappers take CUDA tensors only; ``ops.py`` picks the plain version
for CPU tensors. Each counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64 = ctypes.c_int64
_P = ctypes.c_void_p


def _lib():
    lib = build.load("rectify")
    if not getattr(lib, "_typed", False):
        lib.fused_step_rectify_f32.argtypes = [_P] * 10 + [_I64, _I64, _P]
        lib.fused_step_rectify_f32.restype = ctypes.c_int
        lib.fused_step_rectify_accept_f32.argtypes = \
            [_P] * 15 + [_I64, _I64, _I64, _P]
        lib.fused_step_rectify_accept_f32.restype = ctypes.c_int
        lib.rectify_num_tiles.argtypes = [_I64]
        lib.rectify_num_tiles.restype = _I64
        lib._typed = True
    return lib


def _check_operands(lat, scal, fire):
    dev = lat[0].device
    if dev.type != "cuda":
        raise ValueError(f"rectify kernel needs CUDA tensors, got {dev}")
    rows, m = lat[0].shape
    for t in lat:
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != m or not t.is_contiguous():
            raise ValueError("rectify kernel: latents must be contiguous f32 "
                             f"[R, M] on {dev}, got {t.dtype} {tuple(t.shape)}")
    for t in scal:
        if t.device != dev or t.dtype != torch.float32 \
                or t.shape != (rows,) or not t.is_contiguous():
            raise ValueError(f"rectify kernel: dt/dsnap must be f32 [{rows}]")
    if fire.device != dev or fire.dtype != torch.bool or fire.shape != (rows,):
        raise ValueError(f"rectify kernel: fire must be bool [{rows}]")
    if rows > 65535:
        raise ValueError(f"rectify kernel: at most 65535 rows, got {rows}")
    return dev, rows, m


def fused_step_rectify(x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire):
    """[R, M] latents, [R] dt/dsnap/fire -> out [R, M] (CUDA)."""
    lat = (x, f, x_up, f_up, x_snap, f_snap)
    dev, rows, m = _check_operands(lat, (dt, dsnap), fire)
    fire_u8 = fire.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.fused_step_rectify_f32(
        *map(build.ptr, lat), build.ptr(dt), build.ptr(dsnap),
        build.ptr(fire_u8), build.ptr(out), rows, m,
        build.stream_handle(dev))
    build.check(lib, "rectify", err)
    fused_step_rectify.launches += 1
    return out


fused_step_rectify.launches = 0


def fused_step_rectify_accept(x, f, x_up, f_up, x_snap, f_snap, prev,
                              dt, dsnap, fire):
    """Update + accept sums. prev: [P, M] with R divisible by P (row r uses
    ``prev[r // (R // P)]``). Returns (out [R, M], err_sq [R], out_sq [R])."""
    lat = (x, f, x_up, f_up, x_snap, f_snap)
    dev, rows, m = _check_operands(lat, (dt, dsnap), fire)
    p = prev.shape[0]
    if prev.device != dev or prev.dtype != torch.float32 \
            or prev.shape != (p, m) or not prev.is_contiguous() \
            or p == 0 or rows % p:
        raise ValueError(f"rectify accept: prev must be contiguous f32 [P, "
                         f"{m}] with {rows} % P == 0, got {tuple(prev.shape)}")
    lib = _lib()
    tiles = lib.rectify_num_tiles(m)
    fire_u8 = fire.to(torch.uint8).contiguous()
    out = torch.empty_like(x)
    parts = torch.empty((2, rows, tiles), dtype=torch.float32, device=dev)
    sums = torch.empty((2, rows), dtype=torch.float32, device=dev)
    err = lib.fused_step_rectify_accept_f32(
        *map(build.ptr, lat), build.ptr(prev), build.ptr(dt),
        build.ptr(dsnap), build.ptr(fire_u8), build.ptr(out),
        build.ptr(parts[0]), build.ptr(parts[1]), build.ptr(sums[0]),
        build.ptr(sums[1]), rows, m, rows // p, build.stream_handle(dev))
    build.check(lib, "rectify", err)
    fused_step_rectify_accept.launches += 1
    return out, sums[0], sums[1]


fused_step_rectify_accept.launches = 0
