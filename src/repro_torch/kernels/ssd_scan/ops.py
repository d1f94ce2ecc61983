"""SSD chunk dispatcher: the CUDA kernel for CUDA tensors, the plain
batched version (``ref.py``) for CPU tensors and whenever ``use_kernel`` is
False. DTensor operands (a mesh) run on each rank's own rows and heads
(:func:`on_shards`)."""
from __future__ import annotations

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels import mesh, on_cuda
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref


def ssd_chunk(c_mat, b_mat, xdt, cum, use_kernel: bool = True):
    if is_dtensor(xdt):
        return on_shards(
            lambda *a: ssd_chunk(*a, use_kernel=use_kernel),
            c_mat, b_mat, xdt, cum)
    if use_kernel and on_cuda(xdt):
        return kernel.ssd_chunk(c_mat, b_mat, xdt, cum)
    return ssd_chunk_batched_ref(c_mat, b_mat, xdt, cum)


def on_shards(fn, c_mat, b_mat, xdt, cum):
    """``fn`` (a chunk function of plain tensors) on each rank's local
    blocks of DTensor operands: the rows ``G`` and the heads ``H`` may be
    split (C and B are per row, shared by every head: whole over the heads'
    mesh dims), the chunk ``Lc``, head dim and state whole. Returns (y,
    s_local) laid out as ``xdt``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lay = tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                else Replicate() for p in xdt.placements)
    row = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in lay)
    args = []
    for a, want in ((c_mat, row), (b_mat, row), (xdt, lay), (cum, lay)):
        if tuple(a.placements) != want:
            mesh.REDISTRIBUTES["ssd_chunk"] += 1
            a = a.redistribute(a.device_mesh, want)
        args.append(a.to_local())
    y, st = fn(*args)
    dm = xdt.device_mesh
    return (DTensor.from_local(y, dm, lay, run_check=False),
            DTensor.from_local(st, dm, lay, run_check=False))
