"""Device meshes — port of ``repro.launch.mesh``.

Torch is multi-controller: every rank of the default process group builds
the same mesh. :func:`make_mesh` returns a ``DeviceMesh`` named by
``axes`` over the first ``prod(shape)`` ranks (NCCL on the card, gloo with
``device="cpu"``); a rank past them is outside the mesh
(``mesh.get_coordinate()`` is None) but still takes part in building its
process groups, as ``torch.distributed.new_group`` asks of every rank.
"""
from __future__ import annotations

import math


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_mesh(shape, axes, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks
    ``0 .. prod(shape) - 1`` (``device`` "cuda": NCCL, "cpu": gloo)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    need = math.prod(shape)
    have = _world()
    if have < need:
        raise RuntimeError(f"need {need} ranks for mesh {shape}, have {have}")
    ranks = torch.arange(need, dtype=torch.int).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16,16)=(data,model) single pod (256 chips) or
    (2,16,16)=(pod,data,model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = _world()
    if have < need:
        raise RuntimeError(f"need {need} devices for mesh {shape}, have "
                           f"{have}")
    return make_mesh(shape, axes, device=device)


def dp_size(mesh) -> int:
    """Total data-parallel ways (pod x data)."""
    from repro_torch.dist.sharding import mesh_sizes

    sizes = mesh_sizes(mesh)
    return sizes["data"] * sizes.get("pod", 1)
