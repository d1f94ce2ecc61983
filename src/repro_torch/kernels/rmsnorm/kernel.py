"""ctypes binding of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``rmsnorm``
(``src/repro/kernels/rmsnorm/kernel.py``). Bound on the card: bytes (one
read and one write of x, ~4 flops per element); one block per row reduces
the sum of squares in f32, so no row padding is needed. CUDA tensors only;
``ops.py`` picks the plain version for CPU tensors. Launches are counted in
``rmsnorm.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load("rmsnorm")
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_fwd.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.rmsnorm_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def rmsnorm(x, w, eps: float = 1e-6):
    """x: [..., D] (f32 or bf16), w: [D] (f32 or bf16) on CUDA."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel needs CUDA tensors, got {x.device}"
                         f" / {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm kernel: unsupported dtypes {x.dtype}, "
                         f"{w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm kernel: w must be [{d}], got "
                         f"{tuple(w.shape)}")
    xf = x.reshape(-1, d).contiguous()
    wc = w.contiguous()
    out = torch.empty_like(xf)
    lib = _lib()
    err = lib.rmsnorm_fwd(build.ptr(xf), build.ptr(wc), build.ptr(out),
                          xf.shape[0], d, float(eps), DTYPE_CODES[x.dtype],
                          DTYPE_CODES[w.dtype], build.stream_handle(x.device))
    build.check(lib, "rmsnorm", err)
    rmsnorm.launches += 1
    return out.reshape(x.shape)


rmsnorm.launches = 0
