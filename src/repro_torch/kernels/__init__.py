"""Hand-written CUDA kernels for Hopper, one family per TPU kernel they
replace: ``rectify`` (fused CHORDS step + rectify, and its accept variant),
``rmsnorm``, ``flash_attention`` and ``ssd_scan`` (the Mamba2 SSD
intra-chunk block), and ``device_loop``, the exit condition of the
multi-round device loop. Each family keeps the reference's
three-file split — ``ref.py`` (plain PyTorch version), ``kernel.py``
(ctypes binding of ``csrc/<family>.cu``) and ``ops.py`` (dispatcher).

``use_kernel(s)=True`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no interpret mode. Every kernel
counts its own launches on the device, from thread 0 of block 0 as it
starts (``csrc/launch_count.cuh``), so :func:`launch_counts` counts what
ran on the card — eager launches and those a CUDA graph replays alike (a
graph runs its kernels without calling their wrappers) — which is how a run
shows that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

# kernel -> (family, its counter slot in csrc/<family>.cu)
COUNTERS = {"fused_step_rectify": ("rectify", 0),
            "fused_step_rectify_accept": ("rectify", 1),
            "rmsnorm": ("rmsnorm", 0),
            "flash_attention": ("flash_attention", 0),
            "ssd_chunk": ("ssd_scan", 0),
            "device_loop": ("device_loop", 0)}


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _device_counts(reset: bool) -> Dict[str, int]:
    from repro_torch.kernels import build
    slots: Dict[str, int] = {}
    for family, slot in COUNTERS.values():
        slots[family] = max(slots.get(family, 0), slot + 1)
    if any(family in build._libs for family in slots):
        import torch
        torch.cuda.synchronize()  # every stream's kernels have counted
    got = {family: build.launch_counts(family, n, reset)
           for family, n in slots.items()}
    return {name: got[family][slot]
            for name, (family, slot) in COUNTERS.items()}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel on the current device since the last reset,
    counted by the kernels themselves (zeros on a host where none ran).
    Waits for the device."""
    return _device_counts(reset=False)


def reset_launch_counts() -> None:
    """Zero every kernel's launch count on the current device (after
    waiting for the kernels in flight)."""
    _device_counts(reset=True)
