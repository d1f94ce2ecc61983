"""numpy <-> torch bridge and the loader for the JAX package's parameters.

The tests hand both packages the same numpy arrays; parameters made by the
JAX package (``repro.diffusion.init_wrapper``, as a tree of numpy arrays)
load into the port with :func:`load_jax_params`. Names and stacked
``[L, ...]`` layouts are the reference's, so the load is a plain copy.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

# numpy / JAX dtype name -> torch dtype
DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint32": torch.uint32,
    "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name ("bfloat16", np.float32, ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    key = name if isinstance(name, str) else np.dtype(name).name
    try:
        return DTYPES[key]
    except KeyError:
        raise KeyError(f"no torch dtype for {name!r}; known: {sorted(DTYPES)}")


def to_torch(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy (or anything ``np.asarray`` takes, bfloat16 included) ->
    torch tensor on ``device``."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # numpy has no native bf16: go via f32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy (bf16 comes back as f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def load_jax_params(module: nn.Module, np_tree: Mapping) -> nn.Module:
    """Copy the JAX package's parameter tree (nested dicts of numpy arrays)
    into ``module`` (a :class:`repro_torch.utils.pspec.ParamTree`).

    Names must match one to one and shapes exactly; each array is cast to
    the dtype the port stores that parameter in (``ModelConfig.param_dtype``
    for the backbone). Returns ``module``.
    """
    src = _flatten(np_tree)
    dst = dict(module.named_parameters())
    if set(src) != set(dst):
        raise KeyError(f"parameter names differ: only in JAX "
                       f"{sorted(set(src) - set(dst))}, only in the port "
                       f"{sorted(set(dst) - set(src))}")
    with torch.no_grad():
        for name, p in dst.items():
            arr = np.asarray(src[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {arr.shape} vs port "
                                 f"{tuple(p.shape)}")
            p.copy_(to_torch(arr, device=p.device, dtype=p.dtype))
    return module
