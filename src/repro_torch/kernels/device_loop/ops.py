"""Device-loop condition dispatcher: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors and whenever ``use_kernel`` is
False.

On a mesh (DTensor flags, the slots split over mesh dims) the condition
runs on each rank's own slots, and the two facts it decides on, "a slot is
live" and "a slot accepted since entry", are then reduced over the mesh
dims that split the slots (one max-all-reduce of two words): every rank
leaves the loop at the same round, as the reference's one program does.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import on_cuda
from repro_torch.kernels.device_loop import kernel
from repro_torch.kernels.device_loop.ref import EXIT_ON_ACCEPT, loop_step_ref


def loop_step(live, done, done0, ctrl, flags: int, use_kernel: bool = True):
    if is_dtensor(live):
        return _loop_step_mesh(live, done, done0, ctrl, flags, use_kernel)
    if use_kernel and on_cuda(live):
        return kernel.loop_step(live, done, done0, ctrl, flags)
    return loop_step_ref(live, done, done0, ctrl, flags)


def _loop_step_mesh(live, done, done0, ctrl, flags: int, use_kernel: bool):
    from torch.distributed.tensor import Shard

    from repro_torch.dist.collectives import all_reduce_max

    ll, dl, d0l = live.to_local(), done.to_local(), done0.to_local()
    loop_step(ll, dl, d0l, ctrl, flags, use_kernel)  # done0 in place
    mesh = live.device_mesh
    dims = [md for md, p in enumerate(live.placements)
            if isinstance(p, Shard) and int(mesh.shape[md]) > 1]
    if not dims:
        return ctrl[3]
    facts = torch.stack([ll.any(), (dl & ~d0l).any()]).to(torch.int32)
    for md in dims:
        all_reduce_max(facts, mesh.get_group(md))
    go = (ctrl[1] < ctrl[0]) & (facts[0] > 0)
    if flags & EXIT_ON_ACCEPT:
        go = go & (facts[1] == 0)
    ctrl[3] = go.to(torch.int32)
    return ctrl[3]
