"""CUDA launch contract checker — the counterpart of
``repro.analysis.pallas_check``.

Each kernel package exposes ``launch_meta(...)`` (``repro_torch.kernels.
meta``), the description its wrapper takes the launch's numbers from, so
this pass can enumerate the grid and evaluate every operand's origin
function without running the kernel:

* ``tile-map``        — an origin function does not take the three block
                        indices, or returns an origin whose rank differs
                        from its tile's (error).
* ``oob-tile``        — a tile extends past its array in a dim the kernel
                        does not mask: on the card a stray read or write,
                        not Pallas's silent padding (error).
* ``ww-race``         — two blocks write overlapping output tiles: blocks
                        run in parallel and in no order (error).
* ``smem``            — dynamic plus static shared memory over the
                        232,448 B a block may use, or over 48 KB without
                        the launcher's opt-in (``cudaFuncSetAttribute``)
                        (error); over half the budget (info: one block an
                        SM at most).
* ``launch-limit``    — more than 1024 threads a block, ``gridDim.y`` or
                        ``gridDim.z`` over 65535, ``gridDim.x`` over
                        2³¹ − 1, a cluster over 8 blocks or one that does
                        not divide its grid dim (error).
* ``oracle-mismatch`` — the outputs the wrapper allocates and its
                        ``ref.py`` oracle disagree in shape or dtype, run
                        on ``device="meta"`` tensors (error).

Tiles are per block: races between the threads of one block are not this
pass's to see (``sanitize.py`` under ``compute-sanitizer`` on the card).
"""
from __future__ import annotations

import itertools
from typing import Iterable, List, Sequence, Tuple

from repro_torch.analysis.report import Finding
from repro_torch.kernels.meta import CudaLaunch, OperandTile

PASS = "launch"

SMEM_BUDGET_BYTES = 232448   # shared memory a block may use on an H100
SMEM_DEFAULT_BYTES = 48 * 1024  # without cudaFuncSetAttribute
MAX_THREADS = 1024
MAX_GRID = (2 ** 31 - 1, 65535, 65535)
MAX_CLUSTER = 8              # the portable cluster size

Region = Tuple[Tuple[int, int], ...]  # ((origin, extent), ...) per array dim


def grid_points(grid: Sequence[int]) -> List[Tuple[int, ...]]:
    """Every block index of ``grid``, x fastest (CUDA's linear order)."""
    return [p[::-1] for p in itertools.product(
        *(range(g) for g in reversed(tuple(grid))))]


def _regions(tile: OperandTile, points) -> list:
    """[(region, block)] of every block that touches ``tile``: the
    region ((origin, extent) per array dim) of each block whose origin
    function gives one (None: the block does not touch the operand)."""
    f, ext, rank = tile.origin, tile.tile, len(tile.tile)
    regs = []
    for p in points:
        o = f(*p)
        if o is None:
            continue
        if type(o) is not tuple:
            o = (o,)
        if len(o) != rank:
            raise ValueError(f"origin returned {len(o)} coordinates for a "
                             f"tile of rank {rank}")
        regs.append((tuple(zip(o, ext)), tuple(p)))
    return regs


def _overlaps(a: Region, b: Region) -> bool:
    return all(ao < bo + be and bo < ao + ae
               for (ao, ae), (bo, be) in zip(a, b))


def _races(regs: list) -> list:
    """Overlapping pairs among [(region, block)]: one sweep along the dim
    whose origins spread the most (a tile's extent is the same for every
    block), O(n log n) plus the pairs that overlap there."""
    if len(regs) < 2:
        return []
    d = max(range(len(regs[0][0])),
            key=lambda k: len({r[k][0] for r, _ in regs}))
    regs = sorted(regs, key=lambda rp: (rp[0][d][0], rp[1]))
    races = set()
    n = len(regs)
    for i in range(n):
        ra, pa = regs[i]
        end = ra[d][0] + ra[d][1]
        j = i + 1
        while j < n and regs[j][0][d][0] < end:
            rb, pb = regs[j]
            if pa != pb and _overlaps(ra, rb):
                races.add(tuple(sorted((pa, pb))))
            j += 1
    return sorted(races)


def find_races(tile: OperandTile, points: Iterable[Tuple[int, ...]]):
    """All pairs of blocks whose tiles of ``tile`` overlap, canonically
    sorted (so invariant under any order of ``points``): what the
    reference's ``find_races`` gives on the same regions."""
    return _races(_regions(tile, points))


def _out_of_bounds(tile: OperandTile, regs: list) -> list:
    """(block, dim, origin, extent) of every tile that reaches outside its
    array where the kernel does not mask (a block wholly past a masked
    dim's end counts too: the grid covers more than the array)."""
    import numpy as np

    if not regs:
        return []
    o = np.asarray([r for r, _ in regs], dtype=np.int64)[:, :, 0]
    ext = np.asarray(tile.tile, dtype=np.int64)
    shape = np.asarray(tile.array_shape, dtype=np.int64)
    masked = np.zeros(len(ext), bool)
    masked[list(tile.masked)] = True
    over = np.where(masked, (o >= shape) & (ext > 0), o + ext > shape)
    bad = (o < 0) | over
    return [(regs[i][1], int(dm), int(o[i, dm]), int(ext[dm]))
            for i, dm in zip(*np.nonzero(bad))]


def _limits(launch: CudaLaunch, loc: str) -> List[str]:
    bad = []
    if launch.threads > MAX_THREADS:
        bad.append(f"{launch.threads} threads a block (max {MAX_THREADS})")
    for axis, g, cap in zip("xyz", launch.grid, MAX_GRID):
        if not 1 <= g <= cap:
            bad.append(f"gridDim.{axis} = {g} (max {cap})")
    cl = launch.cluster
    if cl[0] * cl[1] * cl[2] > MAX_CLUSTER:
        bad.append(f"a cluster of {cl[0] * cl[1] * cl[2]} blocks (max "
                   f"{MAX_CLUSTER})")
    for axis, g, c in zip("xyz", launch.grid, cl):
        if c < 1 or g % c:
            bad.append(f"cluster dim {axis} = {c} does not divide "
                       f"gridDim.{axis} = {g}")
    return bad


def check_launch(launch: CudaLaunch,
                 smem_budget_bytes: int = SMEM_BUDGET_BYTES
                 ) -> List[Finding]:
    """Statically verify one kernel launch description."""
    findings: List[Finding] = []
    lloc = f"{launch.kernel}:grid{tuple(launch.grid)}"
    bad = _limits(launch, lloc)
    if bad:
        findings.append(Finding(
            PASS, "launch-limit", "error", f"{launch.kernel}:limits",
            f"{lloc}: {'; '.join(bad)} — the launch is refused"))
    points = grid_points(launch.grid)
    seen: dict = {}  # operands that share an origin function and extent

    for role, tiles in (("in", launch.inputs), ("out", launch.outputs)):
        for tile in tiles:
            loc = f"{launch.kernel}:{tile.name}"
            try:
                key = (tile.origin, tile.tile)
                if key not in seen:
                    seen[key] = _regions(tile, points)
                regs = seen[key]
            except TypeError as e:
                findings.append(Finding(
                    PASS, "tile-map", "error", loc,
                    f"{loc}: the origin function does not take the three "
                    f"block indices: {e}"))
                continue
            except ValueError as e:
                findings.append(Finding(
                    PASS, "tile-map", "error", loc, f"{loc}: {e}"))
                continue

            oob = _out_of_bounds(tile, regs)
            if oob:
                p, d, o, e = oob[0]
                findings.append(Finding(
                    PASS, "oob-tile", "error", loc,
                    f"{loc}: {len(oob)} block(s) reach outside the "
                    f"{tile.array_shape} array, e.g. block {p}: dim {d} "
                    f"spans [{o}, {o + e}) and the kernel masks only dims "
                    f"{tile.masked} — a stray access on the card"))

            if role == "out":
                races = _races(regs)
                if races:
                    pa, pb = races[0]
                    findings.append(Finding(
                        PASS, "ww-race", "error", loc,
                        f"{loc}: {len(races)} block pair(s) write "
                        f"overlapping output tiles, e.g. {pa} vs {pb} — "
                        f"blocks run in parallel, in no order"))

    smem = launch.dynamic_smem + launch.static_smem
    sloc = f"{launch.kernel}:block{tuple(launch.block)}:smem{smem}"
    if smem > smem_budget_bytes:
        findings.append(Finding(
            PASS, "smem", "error", sloc,
            f"{sloc}: {smem} B of shared memory a block exceeds the "
            f"{smem_budget_bytes} B budget — the launch is refused"))
    elif smem > SMEM_DEFAULT_BYTES and not launch.smem_opt_in:
        findings.append(Finding(
            PASS, "smem", "error", sloc,
            f"{sloc}: {smem} B of shared memory a block without the "
            f"cudaFuncSetAttribute opt-in above {SMEM_DEFAULT_BYTES} B — "
            f"the launch is refused"))
    elif smem > smem_budget_bytes // 2:
        findings.append(Finding(
            PASS, "smem", "info", sloc,
            f"{sloc}: {smem} B of shared memory a block is over half the "
            f"{smem_budget_bytes} B budget; an SM holds one such block"))
    return findings


def _avals(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))
    if isinstance(tree, (tuple, list)):
        return tuple(_avals(t) for t in tree)
    return repr(tree)


def check_oracle(kernel: str, alloc, ref, args, ref_args=None
                 ) -> List[Finding]:
    """Run the wrapper's output allocation ``alloc`` and the ``ref.py``
    oracle on ``device="meta"`` tensors; compare output shapes/dtypes."""
    ref_args = args if ref_args is None else ref_args
    loc = kernel
    try:
        got = _avals(alloc(*args))
        want = _avals(ref(*ref_args))
    except Exception as e:  # noqa: BLE001 - report, don't crash the run
        return [Finding(PASS, "oracle-mismatch", "error", loc,
                        f"{loc}: evaluation on meta tensors failed: {e!r}")]
    if got != want:
        return [Finding(PASS, "oracle-mismatch", "error", loc,
                        f"{loc}: the wrapper allocates {got} but the ref.py "
                        f"oracle outputs {want}")]
    return []
