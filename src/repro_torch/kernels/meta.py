"""Static launch descriptions of the port's CUDA kernels — the counterpart
of ``repro.kernels.meta``.

Each kernel module exposes ``launch_meta(...)`` returning a
:class:`CudaLaunch`: the grid, block and cluster dimensions, the shared
memory, and one :class:`OperandTile` per operand saying which part of the
operand a block (a CTA) touches. The wrappers take the numbers they hand to
the C entry points FROM that description (the C side checks them and
launches with them), so the static checker (``repro_torch.analysis.
launch_check``) and the launch read the same geometry by construction: the
checker enumerates the grid, evaluates every origin function, and proves
race freedom between blocks, in-bounds tiles, the shared-memory budget and
the hardware's launch limits without running a kernel.

Tiles are described at block granularity. What the threads of one block do
to each other (a race inside a block, a missing barrier) is out of this
description's sight; ``analysis/sanitize.py`` under ``compute-sanitizer``
is the card's check for that. Plain Python: no torch, no CUDA.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple


class OperandTile(NamedTuple):
    """One operand of a launch: its whole array and the tile one block
    touches.

    ``origin(bx, by, bz)`` gives the tile's element origin in the array
    (one entry per array dim) for the block at that grid index, or
    ``None`` where the block does not touch the operand at all (a cluster
    whose rank 0 alone writes a row's sums). ``tile`` is the tile's extent
    per array dim. ``masked`` lists the dims in which the kernel guards its
    tail (the part of a tile past the array's end is neither read nor
    written there); past the end in any other dim is a stray access.
    """

    name: str
    array_shape: Tuple[int, ...]
    dtype: str
    tile: Tuple[int, ...]
    origin: Callable
    masked: Tuple[int, ...] = ()


class CudaLaunch(NamedTuple):
    """A kernel's complete static launch description.

    ``dynamic_smem`` is the launch's dynamic shared memory and
    ``static_smem`` what the kernel declares itself (``__shared__``
    arrays), both in bytes a block; ``smem_opt_in`` says whether the
    launcher raises the kernel's dynamic limit above 48 KB
    (``cudaFuncSetAttribute``). ``cluster`` is the thread block cluster
    ((1, 1, 1): none)."""

    kernel: str                       # e.g. "rectify.step_rectify_kernel"
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    inputs: Tuple[OperandTile, ...] = ()
    outputs: Tuple[OperandTile, ...] = ()
    cluster: Tuple[int, int, int] = (1, 1, 1)
    dynamic_smem: int = 0
    static_smem: int = 0
    smem_opt_in: bool = False

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def dims3(*d: int) -> Tuple[int, int, int]:
    """``d`` padded with ones to three dims (a CUDA ``dim3``)."""
    return tuple(int(x) for x in d) + (1,) * (3 - len(d))


def geometry(launch: CudaLaunch) -> Tuple:
    """The launch as the C side records it (``csrc/launch_count.cuh``,
    ``last_launch``): grid, block, cluster, dynamic and static shared
    bytes."""
    return (tuple(launch.grid), tuple(launch.block), tuple(launch.cluster),
            int(launch.dynamic_smem), int(launch.static_smem))


def row_tile(name: str, shape, dtype: str, rows_of: Callable,
             row_extent: int = 1, masked: Tuple[int, ...] = (),
             ) -> OperandTile:
    """A tile of ``row_extent`` whole rows of a [rows, ...] operand whose
    origin row is ``rows_of(bx, by, bz)`` (None: untouched)."""
    shape = tuple(int(s) for s in shape)

    def origin(bx, by, bz) -> Optional[Tuple[int, ...]]:
        r = rows_of(bx, by, bz)
        return None if r is None else (r,) + (0,) * (len(shape) - 1)

    return OperandTile(name, shape, dtype, (row_extent,) + shape[1:],
                       origin, masked)
