"""RMSNorm dispatcher: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors (and whenever ``use_kernel`` is False). A CUDA DTensor
(a mesh) runs the kernel on each rank's rows, the normalized dim whole
(``kernels/mesh.py``)."""
from __future__ import annotations

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import mesh, on_cuda
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm(x, w, eps: float = 1e-6, use_kernel: bool = True):
    if use_kernel and on_cuda(x):
        if is_dtensor(x):
            return mesh.local_shards(
                "rmsnorm", lambda a, b: kernel.rmsnorm(a, b, eps), (x, w),
                whole=((-1,), (0,)))
        return kernel.rmsnorm(x, w, eps)
    return rmsnorm_ref(x, w, eps)
