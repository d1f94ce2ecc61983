"""ctypes binding of the SSD intra-chunk CUDA kernel (``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``ssd_chunk``
(``src/repro/kernels/ssd_scan/kernel.py``): one launch over the
(batch·chunks, heads) grid computes every chunk's masked decay-attention
block ``y = ((C·Bᵀ) ∘ M)·xdt`` and chunk-local state ``s = (xdt·w)ᵀ·B``.
Inputs and outputs are f32 (the model casts before the call); the products
are f32 FMAs on the CUDA cores, each output one fixed-order sum. The
card's bound at the serving shape is ~0.04 ms either way (bytes and f32
operations), so the kernel computes C·Bᵀ once per block of up to 8 heads
of a g (never per head, never expanded in device memory), reads its
operands as float4 from 4×4 micro-tiles and prefetches the next head's
operands while the current one computes. In practice its products are
held by shared-memory bandwidth and the rest of each head step by latency,
and the two add up (``benchmarks/torch_kernel_ablation.py``). N and hd
must each be one of ``DIMS``; Lc may be anything up to ``MAX_LC`` (the
tail is masked in the kernel). :func:`launch_meta` describes the launch
(``kernels/meta.py``), its head group picked by :func:`pick_group` from
the card's SM count and the blocks an SM holds (queried from the library
once per shape); the wrapper passes the group, the grid and the shared
bytes to the C entry point, which checks them and launches with them.
CUDA tensors only; ``ops.py`` picks the plain version for CPU tensors. The
kernel counts its launches on the device (``kernels.launch_counts``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.meta import CudaLaunch, OperandTile, dims3

DIMS = (8, 16, 32, 64)
# B and one l-tile's C·Bᵀ tiles are held whole in shared memory; 256 is the
# largest ``ssm_chunk`` of any config
MAX_LC = 256
T = 64            # rows of an l-tile and an m-tile (csrc kT)
THREADS = 256     # threads of a block (csrc kThreads)
MAX_GROUP = 8     # heads a block (csrc kMaxGroup)
SMS = 132         # SMs of an H100 SXM
BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum
SM_SMEM = 233472   # shared bytes of an H100 SM, 1024 of them reserved a block


def _lib():
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_chunk_fwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_int64,
                                                    ctypes.c_int,
                                                    ctypes.c_void_p]
        lib.ssd_chunk_fwd.restype = ctypes.c_int
        lib.ssd_chunk_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.ssd_chunk_occupancy.restype = ctypes.c_int
        lib._typed = True
    return lib


def smem_bytes(lc: int, n: int, hd: int) -> int:
    """Dynamic shared memory of a block (csrc ``Smem<N, HD>::floats``):
    B of the chunk, one l-tile's C·Bᵀ tiles, Pt, Xw (or Bt), two xdt and
    two cum buffers, rows padded by 4 floats."""
    tiles = (lc + T - 1) // T
    lb, lx, lt = n + 4, hd + 4, T + 4
    w = max(T * lx, n * lt)
    return 4 * (tiles * T * lb + tiles * T * lt + T * lt + w + 2 * T * lx
                + 2 * tiles * T)


def pick_group(g: int, nh: int, slots: int) -> int:
    """The head-group size: the grid ``g * ceil(nh / hg)`` runs in waves
    of ``slots`` resident blocks, and a block costs about hg head steps
    plus a third of one for its C·Bᵀ (the causal half of 64³ FMAs, against
    ~1.5 × 64³ for a head step's products): minimise waves × (3 hg + 1),
    the larger hg on a tie."""
    best, best_cost = 1, None
    for hg in range(1, min(MAX_GROUP, nh) + 1):
        blocks = g * -(-nh // hg)
        cost = -(-blocks // slots) * (3 * hg + 1)
        if best_cost is None or cost <= best_cost:
            best, best_cost = hg, cost
    return best


def resident_blocks(lc: int, n: int, hd: int) -> int:
    """Blocks an H100 SM holds by shared memory, at most
    ``BLOCKS_PER_SM`` (the card's own count, which registers also bound,
    comes from :func:`device_slots`)."""
    return max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem_bytes(lc, n, hd)
                                                 + 1024)))


@functools.lru_cache(maxsize=512)
def launch_meta(g: int, h: int, lc: int, n: int, hd: int, sms: int = SMS,
                blocks_per_sm: int = None) -> CudaLaunch:
    """The launch over G = ``g`` chunks of ``h`` heads: one block of
    ``THREADS`` per (chunk, group of hg heads), hg from :func:`pick_group`
    for ``sms * blocks_per_sm`` resident blocks (by default
    :func:`resident_blocks`). Block b is group ``b % groups`` of chunk
    ``b // groups``; the last group's heads past h are masked."""
    if blocks_per_sm is None:
        blocks_per_sm = resident_blocks(lc, n, hd)
    hg = pick_group(g, h, sms * blocks_per_sm)
    groups = -(-h // hg)

    def chunk(bx, by, bz):
        return (bx // groups, 0, 0)

    def heads(bx, by, bz):
        return (bx // groups, bx % groups * hg, 0, 0)

    def heads3(bx, by, bz):
        return (bx // groups, bx % groups * hg, 0)

    f32 = "float32"
    ins = (OperandTile("c_mat", (g, lc, n), f32, (1, lc, n), chunk),
           OperandTile("b_mat", (g, lc, n), f32, (1, lc, n), chunk),
           OperandTile("xdt", (g, h, lc, hd), f32, (1, hg, lc, hd), heads,
                       (1,)),
           OperandTile("cum", (g, h, lc), f32, (1, hg, lc), heads3, (1,)))
    outs = (OperandTile("y", (g, h, lc, hd), f32, (1, hg, lc, hd), heads,
                        (1,)),
            OperandTile("s_local", (g, h, hd, n), f32, (1, hg, hd, n), heads,
                        (1,)))
    return CudaLaunch("ssd_scan.ssd_chunk_kernel", dims3(g * groups),
                      dims3(THREADS), ins, outs,
                      dynamic_smem=smem_bytes(lc, n, hd), smem_opt_in=True)


def head_group(launch: CudaLaunch) -> int:
    """The heads a block of ``launch`` takes."""
    return launch.outputs[0].tile[1]


@functools.lru_cache(maxsize=64)
def device_slots(device_index: int, n: int, hd: int, lc: int):
    """(SMs, resident blocks an SM holds of the (n, hd) kernel at chunk
    ``lc``) on a CUDA device."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _lib().ssd_chunk_occupancy(n, hd, lc, ctypes.byref(per_sm))
    build.check(_lib(), "ssd_scan", err)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    if per_sm.value < 1:
        raise RuntimeError(f"ssd_chunk kernel: no block of N={n}, hd={hd}, "
                           f"Lc={lc} fits an SM")
    return sms, per_sm.value


@functools.lru_cache(maxsize=256)
def _launch_args(device_index: int, g: int, h: int, lc: int, n: int,
                 hd: int):
    """(head group, grid x, dynamic shared bytes) of :func:`launch_meta`
    on a CUDA device, as ``ssd_chunk_fwd`` takes them."""
    m = launch_meta(g, h, lc, n, hd, *device_slots(device_index, n, hd, lc))
    return head_group(m), m.grid[0], m.dynamic_smem


def outputs(c_mat, b_mat, xdt, cum):
    """(y, s_local) as the wrapper allocates them."""
    g, h, lc, hd = xdt.shape
    return torch.empty_like(xdt), xdt.new_empty((g, h, hd, c_mat.shape[2]))


def ssd_chunk(c_mat, b_mat, xdt, cum):
    """c_mat/b_mat: [G, Lc, N]; xdt: [G, H, Lc, hd]; cum: [G, H, Lc], all
    f32 on CUDA. Returns (y [G, H, Lc, hd], s_local [G, H, hd, N])."""
    ts = (c_mat, b_mat, xdt, cum)
    if any(t.device.type != "cuda" or t.device != xdt.device for t in ts):
        raise ValueError(f"ssd_chunk kernel needs CUDA tensors on one device,"
                         f" got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"ssd_chunk kernel takes f32 only, got "
                         f"{[t.dtype for t in ts]}")
    if xdt.ndim != 4 or c_mat.ndim != 3:
        raise ValueError(f"ssd_chunk kernel: xdt must be [G, H, Lc, hd] and "
                         f"C/B [G, Lc, N], got {tuple(xdt.shape)} and "
                         f"{tuple(c_mat.shape)}")
    g, h, lc, hd = xdt.shape
    n = c_mat.shape[2]
    if c_mat.shape != (g, lc, n) or b_mat.shape != c_mat.shape \
            or cum.shape != (g, h, lc):
        raise ValueError(f"ssd_chunk kernel: shapes do not match: C "
                         f"{tuple(c_mat.shape)}, B {tuple(b_mat.shape)}, "
                         f"xdt {tuple(xdt.shape)}, cum {tuple(cum.shape)}")
    if n not in DIMS or hd not in DIMS or not 1 <= lc <= MAX_LC:
        raise ValueError(f"ssd_chunk kernel: N={n} and hd={hd} must be in "
                         f"{DIMS} and Lc={lc} in [1, {MAX_LC}]")
    cc, bc, xc, uc = (build.operand(t) for t in ts)
    y, s = outputs(cc, bc, xc, uc)
    if not (g and h):
        return y, s
    dev = xdt.get_device()
    lib = _lib()
    err = lib.ssd_chunk_fwd(build.ptr(cc), build.ptr(bc), build.ptr(xc),
                            build.ptr(uc), build.ptr(y), build.ptr(s), g, h,
                            lc, n, hd, *_launch_args(dev, g, h, lc, n, hd),
                            build.stream_handle(dev))
    build.check(lib, "ssd_scan", err)
    return y, s
