"""Hand-written CUDA kernels for Hopper, one family per TPU kernel they
replace: ``rectify`` (fused CHORDS step + rectify, and its accept variant),
``rmsnorm``, ``flash_attention`` and ``ssd_scan`` (the Mamba2 SSD
intra-chunk block). Each family keeps the reference's
three-file split — ``ref.py`` (plain PyTorch version), ``kernel.py``
(ctypes binding of ``csrc/<family>.cu``) and ``ops.py`` (dispatcher).

``use_kernel(s)=True`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no interpret mode. Every wrapper
counts its launches (:func:`launch_counts`), which is how a run shows that
its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _wrappers() -> Dict[str, object]:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rectify import kernel as rk
    from repro_torch.kernels.rmsnorm import kernel as rn
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"fused_step_rectify": rk.fused_step_rectify,
            "fused_step_rectify_accept": rk.fused_step_rectify_accept,
            "rmsnorm": rn.rmsnorm,
            "flash_attention": fa.flash_attention,
            "ssd_chunk": ssd.ssd_chunk}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
