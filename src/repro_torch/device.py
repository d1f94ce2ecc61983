"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, refusing a CUDA request on a
    host without a usable GPU.

    The port's entry points default to ``"cuda"``; the refusal keeps a run
    that was meant for the card from quietly measuring the CPU instead.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    # "cuda" -> "cuda:<current>", the device tensors report once moved there
    return dev if dev.index is not None else \
        torch.device("cuda", torch.cuda.current_device())
