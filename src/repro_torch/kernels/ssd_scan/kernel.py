"""ctypes binding of the SSD intra-chunk CUDA kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``ssd_chunk``
(``src/repro/kernels/ssd_scan/kernel.py``): one launch over the
(batch·chunks, heads) grid computes every chunk's masked decay-attention
block ``y = ((C·Bᵀ) ∘ M)·xdt`` and chunk-local state ``s = (xdt·w)ᵀ·B``.
Inputs and outputs are f32 (the model casts before the call); the products
are f32 FMAs on the CUDA cores, each output one fixed-order sum. The
card's bound at the serving shape is ~0.04 ms either way (bytes and f32
operations), so the kernel computes C·Bᵀ once per block of up to 8 heads
of a g (never per head, never expanded in device memory), reads its
operands as float4 from 4×4 micro-tiles and prefetches the next head's
operands while the current one computes. In practice its products are
held by shared-memory bandwidth and the rest of each head step by latency,
and the two add up (``benchmarks/torch_kernel_ablation.py``). N and hd
must each be one of
``DIMS``; Lc may be anything up to ``MAX_LC`` (the tail is masked in the
kernel). CUDA tensors only; ``ops.py`` picks the plain version for CPU
tensors. The kernel counts its launches on the device
(``kernels.launch_counts``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DIMS = (8, 16, 32, 64)
# B and one l-tile's C·Bᵀ tiles are held whole in shared memory; 256 is the
# largest ``ssm_chunk`` of any config
MAX_LC = 256


def _lib():
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_chunk_fwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ssd_chunk_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def ssd_chunk(c_mat, b_mat, xdt, cum):
    """c_mat/b_mat: [G, Lc, N]; xdt: [G, H, Lc, hd]; cum: [G, H, Lc], all
    f32 on CUDA. Returns (y [G, H, Lc, hd], s_local [G, H, hd, N])."""
    ts = (c_mat, b_mat, xdt, cum)
    if any(t.device.type != "cuda" or t.device != xdt.device for t in ts):
        raise ValueError(f"ssd_chunk kernel needs CUDA tensors on one device,"
                         f" got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"ssd_chunk kernel takes f32 only, got "
                         f"{[t.dtype for t in ts]}")
    if xdt.ndim != 4 or c_mat.ndim != 3:
        raise ValueError(f"ssd_chunk kernel: xdt must be [G, H, Lc, hd] and "
                         f"C/B [G, Lc, N], got {tuple(xdt.shape)} and "
                         f"{tuple(c_mat.shape)}")
    g, h, lc, hd = xdt.shape
    n = c_mat.shape[2]
    if c_mat.shape != (g, lc, n) or b_mat.shape != c_mat.shape \
            or cum.shape != (g, h, lc):
        raise ValueError(f"ssd_chunk kernel: shapes do not match: C "
                         f"{tuple(c_mat.shape)}, B {tuple(b_mat.shape)}, "
                         f"xdt {tuple(xdt.shape)}, cum {tuple(cum.shape)}")
    if n not in DIMS or hd not in DIMS or not 1 <= lc <= MAX_LC:
        raise ValueError(f"ssd_chunk kernel: N={n} and hd={hd} must be in "
                         f"{DIMS} and Lc={lc} in [1, {MAX_LC}]")
    cc, bc, xc, uc = (build.operand(t) for t in ts)
    y = torch.empty_like(xc)
    s = torch.empty((g, h, hd, n), dtype=torch.float32, device=xdt.device)
    lib = _lib()
    err = lib.ssd_chunk_fwd(build.ptr(cc), build.ptr(bc), build.ptr(xc),
                            build.ptr(uc), build.ptr(y), build.ptr(s), g, h,
                            lc, n, hd, build.stream_handle(xdt.get_device()))
    build.check(lib, "ssd_scan", err)
    return y, s
