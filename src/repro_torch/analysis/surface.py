"""The serve surface the analyzer lints: executor programs + kernel launches
— port of ``repro.analysis.surface``.

One place defines WHAT gets checked so the CLI, the tests and the card's
smoke all check the same thing: the full bucket ladder a
``ContinuousEngine`` walks (``engine.bucket_ladder``) with and without the
default lane profile, the batch streaming program, lane migration between
adjacent buckets, and every CUDA kernel's launch at the reference's five
representative shapes, at the shapes of PERF.md §6 (rows 1–5′, the
served models' shapes), at 65537 rows for the step and accept kernels (past
the 65535 a grid's y could hold), and the device loop's condition. The
drift is the analytic ``-x * t`` (program structure does not depend on the
drift's weights). Programs are traced on the CPU; kernel cases carry their
arguments' shapes, so the oracle check runs on ``device="meta"`` and the
card (``analysis/sanitize.py``) launches the same cases.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple

N_STEPS = 20
NUM_CORES = 4
MIN_SLOTS = 4
MAX_SLOTS = 16
LATENT_SHAPE = (8,)
RTOL = 0.05


def drift(x, t):
    """``-x * t``, the reference surface's drift, on the port's rows
    (``t`` one time a row)."""
    return -x * t.reshape((-1,) + (1,) * (x.dim() - 1))


def make_executor(device="cpu"):
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.serve.executor import RoundExecutor

    return RoundExecutor(drift, uniform_tgrid(N_STEPS, device=device),
                         N_STEPS)


def grid_ladder(min_slots: int = MIN_SLOTS, max_slots: int = MAX_SLOTS
                ) -> List:
    """One GridSpec per capacity bucket an elastic engine can visit."""
    from repro_torch.serve.engine import bucket_ladder
    from repro_torch.serve.executor import GridSpec

    return [GridSpec(num_slots=s, num_cores=NUM_CORES,
                     latent_shape=LATENT_SHAPE)
            for s in bucket_ladder(min_slots, max_slots)]


def stream_specs() -> List:
    from repro_torch.core.init_sequence import make_sequence
    from repro_torch.serve.executor import StreamSpec

    i_seq = tuple(make_sequence(NUM_CORES, N_STEPS))
    return [StreamSpec(num_cores=NUM_CORES, i_seq=i_seq, rtol=RTOL,
                       batched=b) for b in (False, True)]


def lane_grid_ladder(min_slots: int = MIN_SLOTS, max_slots: int = MAX_SLOTS
                     ) -> List:
    """:func:`grid_ladder` with the default draft/refine lane profile for
    ``NUM_CORES``: a separate ladder, since a homogeneous grid carries no
    lane state and migrate pairs never mix the two."""
    from repro_torch.core.chords import default_lane_profile
    from repro_torch.serve.engine import bucket_ladder
    from repro_torch.serve.executor import GridSpec

    profile = default_lane_profile(NUM_CORES)
    return [GridSpec(num_slots=s, num_cores=NUM_CORES,
                     latent_shape=LATENT_SHAPE, lane_profile=profile)
            for s in bucket_ladder(min_slots, max_slots)]


def migrate_pairs(ladder=None) -> List[Tuple]:
    """Adjacent-bucket (src, dst) GridSpec pairs, both directions."""
    ladder = grid_ladder() if ladder is None else ladder
    pairs = []
    for a, b in zip(ladder, ladder[1:]):
        pairs += [(a, b), (b, a)]
    return pairs


def enumerate_serve_programs(executor=None) -> List:
    ex = make_executor() if executor is None else executor
    return ex.enumerate_programs(
        grid_specs=grid_ladder() + lane_grid_ladder(),
        stream_specs=stream_specs(),
        stream_latent_shape=LATENT_SHAPE,
        migrate_pairs=migrate_pairs() + migrate_pairs(lane_grid_ladder()))


# -- kernel cases -------------------------------------------------------------

class KernelCase(NamedTuple):
    """One kernel launch at one shape.

    ``launch`` is the kernel's launch description; ``alloc`` the outputs
    its wrapper allocates and ``ref`` its ``ref.py`` oracle (both run on
    ``make("meta")`` for the oracle check). On the card ``op`` (the CUDA
    wrapper) and ``plain`` (what the ``kernels`` phase of the smoke holds
    it to) run on the same ``make("cuda", gen)`` arguments; ``tol`` is that
    phase's tolerance (0: bitwise). ``family`` names the library whose
    ``last_launch`` the card reads."""

    name: str
    family: str
    launch: object
    alloc: Callable
    ref: Callable
    make: Callable        # (device, gen=None) -> argument tuple
    op: Callable
    plain: Callable
    tol: float


def _tensor(shape, dtype, device, gen, kind="normal"):
    import torch
    if device == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if kind == "bool":
        return torch.rand(shape, generator=gen, device=device) < 0.5
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=device).to(dtype)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _rectify_case(rows: int, m: int, p: Optional[int] = None,
                  tag: str = "") -> KernelCase:
    import torch

    from repro_torch.kernels.rectify import kernel as K
    from repro_torch.kernels.rectify import ref as R

    f32 = torch.float32

    def make(device, gen=None):
        lat = tuple(_tensor((rows, m), f32, device, gen) for _ in range(6))
        prev = () if p is None else (_tensor((p, m), f32, device, gen),)
        sc = tuple(_tensor((rows,), f32, device, gen, "uniform")
                   for _ in range(2))
        return lat + prev + sc + (_tensor((rows,), torch.bool, device, gen,
                                          "bool"),)

    if p is None:
        return KernelCase(f"rectify[{rows}x{m}]{tag}", "rectify",
                          K.launch_meta(rows, m), K.step_outputs,
                          R.fused_step_rectify_ref, make,
                          K.fused_step_rectify, R.fused_step_rectify_ref, 0.0)

    def plain(*a):
        out, _, _ = R.fused_step_rectify_accept_ref(*a)
        return (out, *R.accept_sums_in_kernel_order(
            out, a[6], *K.accept_plan(rows, m, True)))

    return KernelCase(f"rectify_accept[{rows}x{m},p{p}]{tag}", "rectify",
                      K.launch_meta_accept(rows, m, p), K.accept_outputs,
                      R.fused_step_rectify_accept_ref, make,
                      K.fused_step_rectify_accept, plain, 0.0)


def _rmsnorm_case(rows: int, d: int, dtype: str) -> KernelCase:
    import torch

    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    dt = getattr(torch, dtype)

    def make(device, gen=None):
        return (_tensor((rows, d), dt, device, gen),
                _tensor((d,), dt, device, gen))

    return KernelCase(f"rmsnorm[{rows}x{d},{dtype}]", "rmsnorm",
                      K.launch_meta(rows, d, dt, dt), K.outputs, rmsnorm_ref,
                      make, K.rmsnorm, rmsnorm_ref,
                      1e-5 if dtype == "float32" else 5e-2)


def _flash_case(b: int, sq: int, h: int, kvh: int, dh: int, dtype: str,
                causal: bool, sk: Optional[int] = None) -> KernelCase:
    import torch

    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dt = getattr(torch, dtype)
    sk = sq if sk is None else sk

    def make(device, gen=None):
        return (_tensor((b, sq, h, dh), dt, device, gen),
                _tensor((b, sk, kvh, dh), dt, device, gen),
                _tensor((b, sk, kvh, dh), dt, device, gen))

    ref = functools.partial(attention_ref, causal=causal)
    return KernelCase(
        f"flash_attention[{b},{sq},{h}/{kvh},{dh},{dtype}"
        f"{',causal' if causal else ''}]", "flash_attention",
        K.launch_meta(dt, dh, b, sq, sk, h, kvh, causal), K.outputs, ref,
        make, functools.partial(K.flash_attention, causal=causal), ref,
        2e-5 if dtype == "float32" else 2e-2)


def _ssd_case(g: int, h: int, lc: int, n: int, hd: int, sms: int,
              slots: Optional[Callable]) -> KernelCase:
    import torch

    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref

    f32 = torch.float32

    def make(device, gen=None):
        cum = _tensor((g, h, lc), f32, device, gen, "uniform")
        if device != "meta":  # an inclusive cumulative log-decay
            cum = -torch.cumsum(cum, dim=-1)
        return (_tensor((g, lc, n), f32, device, gen),
                _tensor((g, lc, n), f32, device, gen),
                _tensor((g, h, lc, hd), f32, device, gen), cum)

    per_sm = None if slots is None else slots(n, hd, lc)
    return KernelCase(f"ssd_scan[{g},{h},{lc},{n},{hd}]", "ssd_scan",
                      K.launch_meta(g, h, lc, n, hd, sms, per_sm), K.outputs,
                      ssd_chunk_batched_ref, make, K.ssd_chunk,
                      ssd_chunk_batched_ref, 1e-4)


def _loop_case(s: int) -> KernelCase:
    import torch

    from repro_torch.kernels.device_loop import kernel as K
    from repro_torch.kernels.device_loop.ref import (EXIT_ON_ACCEPT, FIRST,
                                                     loop_step_ref)

    flags = EXIT_ON_ACCEPT | FIRST

    def make(device, gen=None):
        ctrl = torch.tensor([8, 0, 0, 0], dtype=torch.int32)
        return (_tensor((s,), torch.bool, device, gen, "bool"),
                _tensor((s,), torch.bool, device, gen, "bool"),
                torch.zeros(s, dtype=torch.bool, device=device),
                ctrl.to(device))

    def both(fn):
        def run(live, done, done0, ctrl):
            return fn(live, done, done0, ctrl, flags), done0, ctrl
        return run

    return KernelCase(f"device_loop[{s}]", "device_loop", K.launch_meta(s),
                      K.outputs, functools.partial(loop_step_ref,
                                                   flags=flags),
                      make, both(K.loop_step), both(loop_step_ref), 0.0)


def kernel_cases(sms: int = 132, slots: Optional[Callable] = None
                 ) -> List[KernelCase]:
    """Every kernel case. ``sms`` and ``slots`` (``(n, hd, lc) -> blocks
    an SM holds``, the card's own count; by default the kernel module's
    estimate) pick ``ssd_chunk``'s head group as its wrapper does."""
    k, m = NUM_CORES, 8192
    return [
        # the reference's five representative shapes (f32)
        _flash_case(2, 256, 4, 2, 64, "float32", True),
        _rmsnorm_case(512, 128, "float32"),
        _ssd_case(4, 2, 256, 64, 64, sms, slots),
        _rectify_case(k, m),
        _rectify_case(k, m, p=k),
        # PERF.md §6 rows 1-5': the served shapes
        _rectify_case(32, 1024),
        _rectify_case(32, 1024, p=4),
        _rmsnorm_case(2048, 3072, "bfloat16"),
        _rmsnorm_case(2048, 2560, "bfloat16"),
        _rmsnorm_case(2048, 5120, "bfloat16"),
        _rmsnorm_case(4, 2560, "bfloat16"),
        _rmsnorm_case(4, 5120, "bfloat16"),
        _rmsnorm_case(2048, 2048, "bfloat16"),
        _flash_case(32, 64, 24, 24, 128, "bfloat16", False),
        _flash_case(2, 1024, 16, 16, 256, "bfloat16", True),
        _flash_case(2, 1024, 16, 16, 256, "float32", True),
        _flash_case(4, 512, 28, 4, 128, "bfloat16", True),
        _flash_case(4, 512, 16, 16, 256, "bfloat16", True),
        _flash_case(4, 512, 32, 32, 80, "bfloat16", True),
        _flash_case(4, 512, 16, 8, 128, "bfloat16", True),
        _ssd_case(32, 80, 64, 64, 64, sms, slots),
        _ssd_case(8, 80, 256, 64, 64, sms, slots),
        # past the 65535 rows a grid's y holds (the folded rows)
        _rectify_case(65537, 64),
        _rectify_case(65537, 64, p=1),
        # row 6: the device loop's condition at the serving grid
        _loop_case(4),
    ]
