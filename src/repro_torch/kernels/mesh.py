"""The kernels on a mesh: run a kernel on each rank's local shard of
DTensor inputs.

A kernel reduces over some dims of its inputs (a row for rmsnorm; the head
dim and the kv sequence for flash attention). Where the layout keeps every
such dim whole on each rank, the kernel runs on the local blocks as they are
and its output is laid out like its first input. Where the layout splits
one, the inputs are first redistributed to the nearest layout that keeps it
whole (that dim replicated), which is what GSPMD inserts around a Pallas
call; each such redistribute is counted in :data:`REDISTRIBUTES`, keyed by
kernel name. A kernel that reduces across the blocks of a split itself (a
collective inside it: decode attention's softmax over a KV cache split
along its sequence) names the mesh dims of that split in ``reduce_over``,
and its inputs keep their blocks there.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Sequence

REDISTRIBUTES: Dict[str, int] = collections.Counter()


def _keep_whole(t, dims: Sequence[int]):
    """``t``'s placements with every Shard of a dim in ``dims`` replicated."""
    from torch.distributed.tensor import Replicate, Shard

    nd = t.dim()
    whole = {d % nd for d in dims}
    return tuple(Replicate() if isinstance(p, Shard) and p.dim in whole
                 else p for p in t.placements)


def split_dims(t, dim: int) -> tuple:
    """The mesh dims of more than one rank over which DTensor ``t`` splits
    its dim ``dim`` (``()`` for a plain tensor)."""
    from torch.distributed.tensor import Shard

    placements = getattr(t, "placements", ())
    d = dim % t.dim()
    return tuple(md for md, p in enumerate(placements)
                 if isinstance(p, Shard) and p.dim == d
                 and t.device_mesh.shape[md] > 1)


def local_shards(name: str, kernel: Callable, args, whole: Sequence[tuple],
                 same_layout: Sequence[int] = (), rows: Sequence = (),
                 reduce_over: Sequence[int] = ()):
    """``kernel(*local blocks, *rows)`` as a DTensor laid out like
    ``args[0]``.

    ``whole[i]``: the dims of ``args[i]`` that must not be split.
    ``same_layout``: indices of args that must share ``args[0]``'s
    placements (flash's k and v with q: a rank's q heads must meet their
    own GQA group's kv heads); where they differ, a mesh dim on which they
    disagree is replicated on all of them. ``rows``: plain tensors (or
    None) indexed by ``args[0]``'s dim 0, the same on every rank (the
    positions of a batch), passed on as this rank's rows. A plain tensor
    in ``args`` (a constant, the same on every rank) is taken as
    replicated: each rank gets the whole of it. ``reduce_over``: mesh
    dims over which ``kernel`` reduces across ranks itself; ``args[0]``
    is replicated on them, the other args keep their blocks there, and
    ``same_layout`` does not compare them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sharding import local_block

    mesh = args[0].device_mesh
    args = [a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    lays = [list(_keep_whole(a, w)) for a, w in zip(args, whole)]
    for md in reduce_over:
        lays[0][md] = Replicate()
    if same_layout:
        group = [0] + list(same_layout)
        for md in range(len(lays[0])):
            if md in reduce_over:
                continue
            if len({repr(lays[i][md]) for i in group}) > 1:
                for i in group:
                    lays[i][md] = Replicate()
    moved = []
    for a, lay in zip(args, lays):
        if tuple(lay) != tuple(a.placements):
            REDISTRIBUTES[name] += 1
            a = a.redistribute(a.device_mesh, lay)
        moved.append(a)
    mesh = moved[0].device_mesh
    by_row = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in moved[0].placements]
    mine = [None if r is None else local_block(r, mesh, by_row)
            for r in rows]
    out = kernel(*(a.to_local() for a in moved), *mine)
    return DTensor.from_local(out, mesh, moved[0].placements,
                              run_check=False)
