"""Plain PyTorch RMSNorm, op for op ``repro.kernels.rmsnorm.ref``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, w, eps: float = 1e-6):
    dt = x.dtype
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.to(torch.float32)).to(dt)
