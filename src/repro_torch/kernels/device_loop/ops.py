"""Device-loop condition dispatcher: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors and whenever ``use_kernel`` is
False."""
from __future__ import annotations

from repro_torch.kernels import on_cuda
from repro_torch.kernels.device_loop import kernel
from repro_torch.kernels.device_loop.ref import loop_step_ref


def loop_step(live, done, done0, ctrl, flags: int, use_kernel: bool = True):
    if use_kernel and on_cuda(live):
        return kernel.loop_step(live, done, done0, ctrl, flags)
    return loop_step_ref(live, done, done0, ctrl, flags)
