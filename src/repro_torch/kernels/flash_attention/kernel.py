"""ctypes binding of the flash-attention forward CUDA kernels
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attention/kernel.py``): online softmax over KV
tiles, scale ``1/sqrt(Dh)``, f32 m/l/acc, optional causal tile skip, GQA
head ``h -> h // (H/KV)``. The dtype picks one of two kernels and nothing
else does. bf16 runs on the tensor cores (``mma.sync`` bf16 products with
f32 sums, the scale applied to S in f32, P rounded to bf16 before PV,
K/V tiles loaded by ``cp.async`` into two buffers); at the serving shapes
its bound is bytes (q/k/v/o once), which its overlapped loads chase. f32
keeps the CUDA-core kernel (f32 FMAs; a bf16 or TF32 product cannot hold
the 2e-5 contract), bound by its shared-memory operand traffic. Sq/Sk
tails are masked in the kernels. Head dims 16, 32, 64, 80 and 128 are
compiled (80: ``zamba2-2.7b``'s shared block; 16: its reduced config).
CUDA tensors only; ``ops.py`` picks the plain version for CPU tensors.
Launches are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, KV, Dh] on CUDA -> [B, Sq, H, Dh]."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel: q/k/v must share f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, dh) or v.shape != k.shape:
        raise ValueError(f"flash kernel: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if dh not in HEAD_DIMS or kvh < 1 or h % kvh:
        raise ValueError(f"flash kernel: head_dim {dh} not in {HEAD_DIMS} or "
                         f"{h} heads not a multiple of {kvh} KV heads")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qc, kc, vc = (build.operand(t) for t in (q, k, v))
    out = torch.empty_like(qc)
    lib = _lib()
    err = lib.flash_attention_fwd(
        build.ptr(qc), build.ptr(kc), build.ptr(vc), build.ptr(out),
        b, sq, sk, h, kvh, dh, float(scale), int(bool(causal)),
        DTYPE_CODES[q.dtype], build.stream_handle(q.device))
    build.check(lib, "flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
