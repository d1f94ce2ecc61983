"""ctypes binding of the fused step+rectify(+accept) CUDA kernels.

Replaces the Pallas TPU kernels ``fused_step_rectify`` and
``fused_step_rectify_accept`` (``src/repro/kernels/rectify/kernel.py``);
the source is ``src/repro_torch/csrc/rectify.cu``. Bound on the card: bytes
(six or seven f32 latent reads and one write per element), so one launch
covers the whole [S*K, M] grid with per-row scalars. At the serving shape
(~1 MB) both kernels are bound by launch latency and one round trip of
loads instead, so their plans spread a row over enough blocks to fill the
SMs: :func:`step_plan` cuts each row into column tiles of one piece per
thread; the accept variant (:func:`accept_plan`) takes one thread block
cluster per row and reduces its sums in the same launch, the block
partials added in rank order through distributed shared memory:
deterministic, no atomics, no scratch in device memory. The rows are
folded into the grid's x (row-major over the row's tiles or cluster), so
any row count launches. :func:`launch_meta` and :func:`launch_meta_accept`
describe each launch (``kernels/meta.py``); the wrappers pass its plan
(one packed word) and its grid to the C entry points, which check them
and launch with them. Both wrappers make one allocation per output, one
ctypes call with pointers, the plan, the grid and the stream as plain
ints, and read ``fire`` as the bool tensor's bytes.

These wrappers take CUDA tensors only; ``ops.py`` picks the plain version
for CPU tensors. Each kernel counts its launches on the device
(``kernels.launch_counts``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.meta import CudaLaunch, OperandTile, dims3, row_tile

_I64 = ctypes.c_int64
_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_CLUSTER = 8      # the portable thread block cluster size
TARGET_BLOCKS = 128  # blocks a launch should reach (132 SMs on an H100)
MAX_THREADS = 256    # threads of a block (csrc kThreads)


def _lib():
    return build.load("rectify")


@functools.cache
def _step_fn():
    """The typed C entry point of the step kernel."""
    fn = _lib().fused_step_rectify_f32
    fn.argtypes = [_P] * 10 + [_I64, _I64, _I, _I64, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _accept_fn():
    """The typed C entry point of the accept kernel."""
    fn = _lib().fused_step_rectify_accept_f32
    fn.argtypes = [_P] * 12 + [_I64] * 4 + [_I, _I64, _P]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(lat, scal, fire):
    """The device index, rows and M of [R, M] f32 latents with [R] f32
    scalars and a [R] bool ``fire``, all contiguous on one CUDA device."""
    x = lat[0]
    if not x.is_cuda:
        raise ValueError(f"rectify kernel needs CUDA tensors, got {x.device}")
    dev, shape, f32 = x.get_device(), x.shape, torch.float32
    if len(shape) != 2:
        raise ValueError(f"rectify kernel: latents must be [R, M], got "
                         f"{tuple(shape)}")
    rows = shape[0]
    for t in lat:
        if t.get_device() != dev or t.dtype is not f32 or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError("rectify kernel: latents must be contiguous f32 "
                             f"{tuple(shape)} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for t in scal:
        if t.get_device() != dev or t.dtype is not f32 \
                or t.shape != (rows,) or not t.is_contiguous():
            raise ValueError(f"rectify kernel: dt/dsnap must be f32 [{rows}]")
    if fire.get_device() != dev or fire.dtype is not torch.bool \
            or fire.shape != (rows,):
        raise ValueError(f"rectify kernel: fire must be bool [{rows}]")
    return dev, rows, shape[1]


class StepPlan(NamedTuple):
    """One launch of the step kernel over [rows, m]: blocks of ``threads``
    threads, ceil(m / (threads * vec)) of them per row, thread t of block
    b taking the ``vec`` columns from (b * threads + t) * vec."""
    threads: int
    vec: int

    @property
    def word(self) -> int:
        """The plan as the C launcher reads it: bits 0-11 threads, bits
        12-15 vec."""
        return self.threads | self.vec << 12


@functools.lru_cache(maxsize=256)
def step_plan(rows: int, m: int, vec_ok: bool) -> StepPlan:
    """The largest power-of-two block (32 to ``MAX_THREADS`` threads) that
    still brings rows x tiles to ``TARGET_BLOCKS``, no larger than the
    row's pieces need; ``vec_ok``: m % 4 == 0 and the operands are 16-byte
    aligned (float4 pieces), else one column a piece."""
    vec = 4 if vec_ok and m % 4 == 0 else 1
    pieces = -(-m // vec)
    threads = MAX_THREADS
    while threads > 32 and (threads // 2 >= pieces
                            or rows * -(-pieces // threads) < TARGET_BLOCKS):
        threads //= 2
    return StepPlan(threads, vec)


_LATENTS = ("x", "f", "x_up", "f_up", "x_snap", "f_snap")
_SCALARS = (("dt", "float32"), ("dsnap", "float32"), ("fire", "bool"))
ACCEPT_STATIC_SMEM = 4 * (2 * (MAX_THREADS // 32) + 2 * MAX_CLUSTER)


@functools.lru_cache(maxsize=256)
def launch_meta(rows: int, m: int, vec_ok: bool = True) -> CudaLaunch:
    """The step kernel's launch over [rows, m] f32 (``step_plan``): block b
    is column tile ``b % tiles`` of row ``b // tiles``, one piece of
    ``vec`` columns a thread; the columns past m are masked."""
    p = step_plan(rows, m, vec_ok)
    width = p.threads * p.vec
    tiles = -(-m // width)

    def lat(bx, by, bz):
        return (bx // tiles, bx % tiles * width)

    def row(bx, by, bz):
        return bx // tiles

    tiles_in = [OperandTile(n, (rows, m), "float32", (1, width), lat, (1,))
                for n in _LATENTS]
    scal = [row_tile(n, (rows,), dt, row) for n, dt in _SCALARS]
    out = OperandTile("out", (rows, m), "float32", (1, width), lat, (1,))
    return CudaLaunch("rectify.step_rectify_kernel", dims3(rows * tiles),
                      dims3(p.threads), tuple(tiles_in + scal), (out,))


@functools.lru_cache(maxsize=256)
def _step_args(rows: int, m: int, aligned: bool):
    """(plan word, grid x) of :func:`launch_meta`, as the C entry takes
    them."""
    return step_plan(rows, m, aligned).word, \
        launch_meta(rows, m, aligned).grid[0]


def step_outputs(x, *_):
    """The output the step wrapper allocates for latents ``x``."""
    return torch.empty_like(x)


def fused_step_rectify(x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire):
    """[R, M] latents, [R] dt/dsnap/fire -> out [R, M] (CUDA)."""
    lat = (x, f, x_up, f_up, x_snap, f_snap)
    dev, rows, m = _check_operands(lat, (dt, dsnap), fire)
    if not fire.is_contiguous():
        fire = fire.contiguous()
    ptrs = [t.data_ptr() for t in lat]
    out = step_outputs(x)
    op = out.data_ptr()
    aligned = (op | ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]
               | ptrs[5]) % 16 == 0
    word, grid_x = _step_args(rows, m, aligned)
    err = _step_fn()(*ptrs, dt.data_ptr(), dsnap.data_ptr(), fire.data_ptr(),
                     op, rows, m, word, grid_x, build.stream_handle(dev))
    if err:
        build.check(_lib(), "rectify", err)
    return out


class AcceptPlan(NamedTuple):
    """One launch of the accept kernel over [rows, m]: a cluster of
    ``cluster`` blocks of ``threads`` threads per row, block b covering
    columns [b*span, min(m, (b+1)*span)), each thread taking ``vec``
    columns (4: float4 loads, or 1) at a time."""
    cluster: int
    span: int
    threads: int
    vec: int


@functools.lru_cache(maxsize=256)
def accept_plan(rows: int, m: int, vec_ok: bool) -> AcceptPlan:
    """The smallest power-of-two cluster (at most ``MAX_CLUSTER``) that
    brings rows x cluster to ``TARGET_BLOCKS``, no larger than the row has
    32-column pieces for; ``vec_ok``: m % 4 == 0 and the operands are
    16-byte aligned."""
    vec = 4 if vec_ok and m % 4 == 0 else 1
    cluster = 1
    while cluster < MAX_CLUSTER and rows * cluster < TARGET_BLOCKS \
            and 2 * cluster * 32 <= m:
        cluster *= 2
    pieces = -(-m // (cluster * vec))  # vec-wide pieces of a block's span
    threads = min(MAX_THREADS, -(-pieces // 32) * 32)
    return AcceptPlan(cluster, pieces * vec, threads, vec)


@functools.lru_cache(maxsize=256)
def launch_meta_accept(rows: int, m: int, p: int,
                       vec_ok: bool = True) -> CudaLaunch:
    """The accept kernel's launch over [rows, m] f32 with ``prev`` [p, m]
    (``accept_plan``): the cluster of blocks [r*C, (r+1)*C) is row r's,
    block rank b covering columns [b*span, (b+1)*span) (masked past m);
    rank 0 alone writes the row's two sums into the [2, rows] buffer."""
    cl, span, threads, vec = accept_plan(rows, m, vec_ok)
    group = rows // p

    def lat(bx, by, bz):
        return (bx // cl, bx % cl * span)

    def prev(bx, by, bz):
        return (bx // cl // group, bx % cl * span)

    def row(bx, by, bz):
        return bx // cl

    def sums(bx, by, bz):
        return (0, bx // cl) if bx % cl == 0 else None

    tiles_in = [OperandTile(n, (rows, m), "float32", (1, span), lat, (1,))
                for n in _LATENTS]
    tiles_in.append(OperandTile("prev", (p, m), "float32", (1, span), prev,
                                (1,)))
    tiles_in += [row_tile(n, (rows,), dt, row) for n, dt in _SCALARS]
    outs = (OperandTile("out", (rows, m), "float32", (1, span), lat, (1,)),
            OperandTile("sums", (2, rows), "float32", (2, 1), sums))
    return CudaLaunch("rectify.step_rectify_accept_kernel",
                      dims3(rows * cl), dims3(threads), tuple(tiles_in), outs,
                      cluster=dims3(cl), static_smem=ACCEPT_STATIC_SMEM)


@functools.lru_cache(maxsize=256)
def _accept_args(rows: int, m: int, p: int, aligned: bool):
    """(span, packed plan, grid x) of :func:`launch_meta_accept`, as the C
    entry takes them."""
    cluster, span, threads, vec = accept_plan(rows, m, aligned)
    return span, cluster | threads << 4 | vec << 16, \
        launch_meta_accept(rows, m, p, aligned).grid[0]


def accept_outputs(x, *_):
    """(out, err_sq, out_sq) as the accept wrapper allocates them: ``out``
    like ``x``, the sums the two rows of one [2, R] f32 buffer."""
    sums = x.new_empty((2, x.shape[0]))
    return torch.empty_like(x), *sums.unbind()


def fused_step_rectify_accept(x, f, x_up, f_up, x_snap, f_snap, prev,
                              dt, dsnap, fire):
    """Update + accept sums. prev: [P, M] with R divisible by P (row r uses
    ``prev[r // (R // P)]``). Returns (out [R, M], err_sq [R], out_sq [R])."""
    lat = (x, f, x_up, f_up, x_snap, f_snap)
    dev, rows, m = _check_operands(lat, (dt, dsnap), fire)
    p = prev.shape[0]
    if prev.get_device() != dev or prev.dtype is not torch.float32 \
            or prev.shape != (p, m) or not prev.is_contiguous() \
            or p == 0 or rows % p:
        raise ValueError(f"rectify accept: prev must be contiguous f32 [P, "
                         f"{m}] with {rows} % P == 0, got {tuple(prev.shape)}")
    if not fire.is_contiguous():
        fire = fire.contiguous()
    ptrs = [t.data_ptr() for t in lat]
    pp = prev.data_ptr()
    out, err_sq, out_sq = accept_outputs(x)
    op = out.data_ptr()
    aligned = (pp | op | ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]
               | ptrs[5]) % 16 == 0
    span, word, grid_x = _accept_args(rows, m, p, aligned)
    err = _accept_fn()(
        *ptrs, pp, dt.data_ptr(), dsnap.data_ptr(), fire.data_ptr(), op,
        err_sq.data_ptr(), rows, m, rows // p, span, word, grid_x,
        build.stream_handle(dev))
    if err:
        build.check(_lib(), "rectify", err)
    return out, err_sq, out_sq
