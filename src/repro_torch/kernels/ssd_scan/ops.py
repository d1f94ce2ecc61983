"""SSD chunk dispatcher: the CUDA kernel for CUDA tensors, the plain
batched version (``ref.py``) for CPU tensors and whenever ``use_kernel`` is
False."""
from __future__ import annotations

from repro_torch.kernels import on_cuda
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref


def ssd_chunk(c_mat, b_mat, xdt, cum, use_kernel: bool = True):
    if use_kernel and on_cuda(xdt):
        return kernel.ssd_chunk(c_mat, b_mat, xdt, cum)
    return ssd_chunk_batched_ref(c_mat, b_mat, xdt, cum)
