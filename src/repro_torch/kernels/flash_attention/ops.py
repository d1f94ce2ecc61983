"""Attention dispatcher: the flash kernel for CUDA tensors, the plain
version (``ref.py``) for CPU tensors and whenever ``use_kernel`` is False.
On a mesh ``models/layers.py::attend`` calls it on each rank's local
shards (``kernels/mesh.py``)."""
from __future__ import annotations

from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def attend(q, k, v, causal: bool = True, use_kernel: bool = True,
           scale=None):
    if use_kernel and on_cuda(q):
        return kernel.flash_attention(q, k, v, causal=causal, scale=scale)
    return attention_ref(q, k, v, causal, scale)
