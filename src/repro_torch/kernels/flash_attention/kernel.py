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
tails are masked in the kernels. Head dims 16, 32, 64, 80, 128 and 256
are compiled (80: ``zamba2-2.7b``'s shared block; 16: its reduced config;
256: ``gemma-7b``); :func:`plan` mirrors each launch's grid and shared
memory, which the CPU tests hold to the card's 227 KB a block.
CUDA tensors only; ``ops.py`` picks the plain version for CPU tensors.
The kernels count their launches on the device (``kernels.launch_counts``).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
BQ = BK = 64                 # query and KV rows a tile, both routes
SMEM_PER_BLOCK = 232448      # bytes of shared memory a block may use (H100)


class FlashPlan(NamedTuple):
    kernel: str
    threads: int
    smem: int      # dynamic shared memory, bytes
    grid: tuple    # (q tiles, heads, batch)


def plan(dtype, dh: int, b: int, sq: int, sk: int, h: int,
         causal: bool) -> FlashPlan:
    """The launch ``csrc/flash_attention.cu`` makes for these shapes (its
    ``launch_bf16`` / ``launch_f32``): bf16 holds Q and one or two K/V
    buffers of 64 rows padded by 16 bytes; f32 holds Q, K, V and P widened
    to f32 with one float of padding a row."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {dh} not in {HEAD_DIMS}")
    grid = ((sq + BQ - 1) // BQ, h, b)
    if dtype == torch.bfloat16:
        n_kv = (sk + BK - 1) // BK
        if causal:
            n_kv = min(n_kv, (sq + BQ - 1) // BQ)
        tile = 2 * BQ * (dh + 8)
        return FlashPlan("flash_fwd_mma_kernel", 128,
                         tile * (1 + 2 * (2 if n_kv > 1 else 1)), grid)
    if dtype == torch.float32:
        smem = 4 * (BQ * (dh + 1) + BK * (dh + 1) + BK * dh + BQ * (BK + 1))
        return FlashPlan("flash_fwd_kernel", 256, smem, grid)
    raise ValueError(f"flash kernel: dtype {dtype} is neither f32 nor bf16")


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
        DTYPE_CODES[q.dtype], build.stream_handle(q.get_device()))
    build.check(lib, "flash_attention", err)
    return out
