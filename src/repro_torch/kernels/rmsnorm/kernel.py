"""ctypes binding of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``rmsnorm``
(``src/repro/kernels/rmsnorm/kernel.py``). Bound on the card: bytes (one
read and one write of x, ~4 flops per element). :func:`plan` picks the
launch from the width, the type and the operands' alignment:

- **rows in registers** for widths up to ``MAX_VECS * BLOCK_THREADS``
  vectors (8192 bf16 or 4096 f32 with 16-byte vectors, 1024 elements one
  at a time): a row's slice stays in registers between the sum of squares
  and the scaled store, so x is read once; several rows share a block,
  which stages w in shared memory once for all of them. Every width of the
  served models takes it (3072, 2560 and 5120 in bf16).
- **two sweeps** for wider rows (5120 f32, for example): one block per
  row, the second sweep re-reads x from L2.

Vectors are 16 bytes when the width is a multiple of 8 bf16 or 4 f32 and
x and w are 16-byte aligned, one element otherwise (an unaligned view is
normalized where it lies, without a copy).

:func:`launch_meta` describes the launch (``kernels/meta.py``); the
wrapper hands its grid and dynamic shared bytes to the C entry point, which
checks them against the plan and launches with them. The wrapper is lean,
because the served models call it 73 or 82 times a round: no reshape or
copy of a contiguous input, one ``torch.empty_like``, pointers and the
current stream's raw handle passed as plain ints, the dtypes and the plan
packed into one int and the launch's grid and shared bytes beside it, all
three cached (:func:`_launch_args`), so the ctypes call takes ten
arguments. CUDA tensors only; ``ops.py``
picks the plain version for CPU tensors. The kernels count their launches
on the device (``kernels.launch_counts``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.meta import CudaLaunch, OperandTile, dims3

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_VECS = 4            # vectors a thread holds of a row (csrc kMaxVecs)
BLOCK_THREADS = 256     # threads of a block, and at most of a row
                        # (csrc kBlockThreads)
ROWS_IN_REGISTERS, TWO_SWEEPS = 0, 1
STATIC_SMEM = 4 * (BLOCK_THREADS // 32)  # both variants' warp partials


class Plan(NamedTuple):
    """How one launch covers a [rows, d] input: ``variant``
    (``ROWS_IN_REGISTERS`` or ``TWO_SWEEPS``), ``vec`` elements per load,
    ``threads_per_row``, ``vecs_per_thread`` (rows in registers: thread t
    holds the row's vectors t, t + T, ..., at most ``MAX_VECS``) and
    ``rows_per_block``."""
    variant: int
    vec: int
    threads_per_row: int
    vecs_per_thread: int
    rows_per_block: int


@functools.lru_cache(maxsize=256)
def plan(d: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The launch for width ``d`` of ``dtype`` (f32 or bf16); ``aligned``:
    x and w are both 16-byte aligned."""
    full = 16 // dtype.itemsize
    vec = full if aligned and d % full == 0 else 1
    nvec = d // vec
    if nvec > MAX_VECS * BLOCK_THREADS:
        return Plan(TWO_SWEEPS, vec, BLOCK_THREADS, 0, 1)
    warps = -(-nvec // (32 * MAX_VECS))
    tpr = 32 * max(1, warps)
    return Plan(ROWS_IN_REGISTERS, vec, tpr, max(1, -(-nvec // tpr)),
                max(1, BLOCK_THREADS // tpr))


@functools.lru_cache(maxsize=256)
def launch_config(d: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
                  aligned: bool) -> int:
    """The dtypes and :func:`plan` packed into the one int that
    ``rmsnorm_fwd`` takes (bit layout in ``csrc/rmsnorm.cu``)."""
    return pack_config(DTYPE_CODES[x_dtype], DTYPE_CODES[w_dtype],
                       plan(d, x_dtype, aligned))


def pack_config(x_code: int, w_code: int, p: Plan) -> int:
    return (x_code | w_code << 1 | p.variant << 2 | p.vec << 4
            | p.vecs_per_thread << 8 | p.threads_per_row << 12
            | p.rows_per_block << 24)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=1024)
def launch_meta(rows: int, d: int, x_dtype: torch.dtype,
                w_dtype: torch.dtype, aligned: bool = True) -> CudaLaunch:
    """The launch over x [rows, d] and w [d] (:func:`plan`): rows in
    registers takes ``rows_per_block`` whole rows a block (the block's rows
    past ``rows`` masked) and w in dynamic shared memory; two sweeps one
    row a block."""
    p = plan(d, x_dtype, aligned)
    xd, wd = _name(x_dtype), _name(w_dtype)
    w = OperandTile("w", (d,), wd, (d,), lambda bx, by, bz: (0,))
    if p.variant == ROWS_IN_REGISTERS:
        rpb = p.rows_per_block

        def rows_of(bx, by, bz):
            return (bx * rpb, 0)

        x = OperandTile("x", (rows, d), xd, (rpb, d), rows_of, (0,))
        y = OperandTile("y", (rows, d), xd, (rpb, d), rows_of, (0,))
        return CudaLaunch("rmsnorm.rmsnorm_rows_kernel",
                          dims3(-(-rows // rpb)),
                          dims3(p.threads_per_row, rpb), (x, w), (y,),
                          dynamic_smem=w_dtype.itemsize * d,
                          static_smem=STATIC_SMEM)

    def row(bx, by, bz):
        return (bx, 0)

    x = OperandTile("x", (rows, d), xd, (1, d), row)
    y = OperandTile("y", (rows, d), xd, (1, d), row)
    return CudaLaunch("rmsnorm.rmsnorm_sweep_kernel", dims3(rows),
                      dims3(p.threads_per_row), (x, w), (y,),
                      static_smem=STATIC_SMEM)


@functools.lru_cache(maxsize=1024)
def _launch_args(rows: int, d: int, x_dtype: torch.dtype,
                 w_dtype: torch.dtype, aligned: bool):
    """(packed config, grid x, dynamic shared bytes) of
    :func:`launch_meta`, as ``rmsnorm_fwd`` takes them."""
    launch = launch_meta(rows, d, x_dtype, w_dtype, aligned)
    return (launch_config(d, x_dtype, w_dtype, aligned), launch.grid[0],
            launch.dynamic_smem)


def outputs(x, *_):
    """The output the wrapper allocates for ``x``."""
    return torch.empty_like(x)


@functools.cache
def _fwd():
    """The typed C entry point (built and loaded at first use)."""
    fn = build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm(x, w, eps: float = 1e-6):
    """x: [..., D] (f32 or bf16), w: [D] (f32 or bf16) on CUDA."""
    if not (x.is_cuda and w.is_cuda) or w.get_device() != x.get_device():
        raise ValueError(f"rmsnorm kernel needs CUDA tensors on one device, "
                         f"got {x.device} / {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm kernel: unsupported dtypes {x.dtype}, "
                         f"{w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm kernel: w must be [{d}], got "
                         f"{tuple(w.shape)}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    xp, wp = x.data_ptr(), w.data_ptr()
    out = outputs(x)
    rows = x.numel() // d if d else 0
    if not rows:
        return out
    config, grid_x, smem = _launch_args(rows, d, x.dtype, w.dtype,
                                        (xp | wp) % 16 == 0)
    err = _fwd()(xp, wp, out.data_ptr(), rows, d, eps, config, grid_x, smem,
                 build.stream_handle(x.get_device()))
    if err:
        build.check(build.load("rmsnorm"), "rmsnorm", err)
    return out
