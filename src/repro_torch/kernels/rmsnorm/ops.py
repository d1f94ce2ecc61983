"""RMSNorm dispatcher: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors (and whenever ``use_kernel`` is False)."""
from __future__ import annotations

from repro_torch.kernels import on_cuda
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x, w, eps: float = 1e-6, use_kernel: bool = True):
    if use_kernel and on_cuda(x):
        return kernel.rmsnorm(x, w, eps)
    return rmsnorm_ref(x, w, eps)
