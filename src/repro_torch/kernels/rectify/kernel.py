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
deterministic, no atomics, no scratch in device memory. Both wrappers make
one allocation per output, one ctypes call with pointers, the plan (one
packed word) and the stream as plain ints, and read ``fire`` as the bool
tensor's bytes.

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
    fn.argtypes = [_P] * 10 + [_I64, _I64, _I, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _accept_fn():
    """The typed C entry point of the accept kernel."""
    fn = _lib().fused_step_rectify_accept_f32
    fn.argtypes = [_P] * 12 + [_I64] * 4 + [_I, _P]
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
    if rows > 65535:
        raise ValueError(f"rectify kernel: at most 65535 rows, got {rows}")
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


def fused_step_rectify(x, f, x_up, f_up, x_snap, f_snap, dt, dsnap, fire):
    """[R, M] latents, [R] dt/dsnap/fire -> out [R, M] (CUDA)."""
    lat = (x, f, x_up, f_up, x_snap, f_snap)
    dev, rows, m = _check_operands(lat, (dt, dsnap), fire)
    if not fire.is_contiguous():
        fire = fire.contiguous()
    ptrs = [t.data_ptr() for t in lat]
    out = torch.empty_like(x)
    op = out.data_ptr()
    aligned = (op | ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]
               | ptrs[5]) % 16 == 0
    err = _step_fn()(*ptrs, dt.data_ptr(), dsnap.data_ptr(), fire.data_ptr(),
                     op, rows, m, step_plan(rows, m, aligned).word,
                     build.stream_handle(dev))
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
    out = torch.empty_like(x)
    sums = x.new_empty((2, rows))
    op = out.data_ptr()
    aligned = (pp | op | ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]
               | ptrs[5]) % 16 == 0
    cluster, span, threads, vec = accept_plan(rows, m, aligned)
    err = _accept_fn()(
        *ptrs, pp, dt.data_ptr(), dsnap.data_ptr(), fire.data_ptr(), op,
        sums.data_ptr(), rows, m, rows // p, span,
        cluster | threads << 4 | vec << 16, build.stream_handle(dev))
    if err:
        build.check(_lib(), "rectify", err)
    return out, *sums.unbind()
