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
256: ``gemma-7b``). :func:`launch_meta` describes each launch
(``kernels/meta.py``: grid, threads, shared memory, the tiles a block
reads and writes); the wrapper passes its grid, threads and shared bytes
to the C entry point, which checks them against the route and launches
with them, and the CPU tests hold its shared memory to the card's 227 KB
a block (:func:`plan` is a view of it).
CUDA tensors only; ``ops.py`` picks the plain version for CPU tensors.
The kernels count their launches on the device (``kernels.launch_counts``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.meta import CudaLaunch, OperandTile, dims3

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
BQ = BK = 64                 # query and KV rows a tile, both routes
SMEM_PER_BLOCK = 232448      # bytes of shared memory a block may use (H100)


class FlashPlan(NamedTuple):
    kernel: str
    threads: int
    smem: int      # dynamic shared memory, bytes
    grid: tuple    # (q tiles, heads, batch)


@functools.lru_cache(maxsize=512)
def launch_meta(dtype, dh: int, b: int, sq: int, sk: int, h: int, kvh: int,
                causal: bool) -> CudaLaunch:
    """The launch ``csrc/flash_attention.cu`` makes for these shapes:
    grid (q tiles of ``BQ`` rows, heads, batch); bf16 holds Q and one or
    two K/V buffers of 64 rows padded by 16 bytes (two only where some q
    tile streams several KV tiles), f32 Q, K, V and P widened to f32 with
    one float of padding a row. Block (x, y, z) writes rows [x*BQ,
    (x+1)*BQ) of head y of batch z and reads K/V of its KV head over the
    KV tiles it streams (tails masked in the kernels)."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash kernel: head_dim {dh} not in {HEAD_DIMS}")
    q_tiles = (sq + BQ - 1) // BQ
    n_kv = (sk + BK - 1) // BK
    if dtype == torch.bfloat16:
        if causal:
            n_kv = min(n_kv, q_tiles)
        tile = 2 * BQ * (dh + 8)
        name, threads = "flash_attention.flash_fwd_mma_kernel", 128
        smem = tile * (1 + 2 * (2 if n_kv > 1 else 1))
    elif dtype == torch.float32:
        name, threads = "flash_attention.flash_fwd_kernel", 256
        smem = 4 * (BQ * (dh + 1) + BK * (dh + 1) + BK * dh + BQ * (BK + 1))
    else:
        raise ValueError(f"flash kernel: dtype {dtype} is neither f32 nor "
                         f"bf16")
    group = h // kvh
    dt = str(dtype).removeprefix("torch.")

    def q_rows(bx, by, bz):
        return (bz, bx * BQ, by, 0)

    def kv_rows(bx, by, bz):
        return (bz, 0, by // group, 0)

    q = OperandTile("q", (b, sq, h, dh), dt, (1, BQ, 1, dh), q_rows, (1,))
    kv = [OperandTile(n, (b, sk, kvh, dh), dt, (1, n_kv * BK, 1, dh),
                      kv_rows, (1,)) for n in ("k", "v")]
    o = OperandTile("o", (b, sq, h, dh), dt, (1, BQ, 1, dh), q_rows, (1,))
    return CudaLaunch(name, dims3(q_tiles, h, b), dims3(threads),
                      (q, *kv), (o,), dynamic_smem=smem, smem_opt_in=True)


def plan(dtype, dh: int, b: int, sq: int, sk: int, h: int,
         causal: bool) -> FlashPlan:
    """:func:`launch_meta`'s kernel, threads, dynamic shared memory and
    grid (which do not depend on the KV heads)."""
    m = launch_meta(dtype, dh, b, sq, sk, h, h, causal)
    return FlashPlan(m.kernel.split(".")[1], m.threads, m.dynamic_smem,
                     m.grid)


@functools.lru_cache(maxsize=512)
def _launch_args(dtype, dh: int, b: int, sq: int, sk: int, h: int, kvh: int,
                 causal: bool):
    """(grid x, threads, dynamic shared bytes) of :func:`launch_meta`, as
    ``flash_attention_fwd`` takes them."""
    m = launch_meta(dtype, dh, b, sq, sk, h, kvh, causal)
    return m.grid[0], m.threads, m.dynamic_smem


def outputs(q, *_):
    """The output the wrapper allocates for (contiguous) ``q``."""
    return torch.empty_like(q)


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
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
    out = outputs(qc)
    causal = bool(causal)
    lib = _lib()
    err = lib.flash_attention_fwd(
        build.ptr(qc), build.ptr(kc), build.ptr(vc), build.ptr(out),
        b, sq, sk, h, kvh, dh, float(scale), int(causal),
        DTYPE_CODES[q.dtype],
        *_launch_args(q.dtype, dh, b, sq, sk, h, kvh, causal),
        build.stream_handle(q.get_device()))
    build.check(lib, "flash_attention", err)
    return out
