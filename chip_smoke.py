#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   — card name, ``nvidia-smi`` name and power limit, ``nvcc``,
              PyTorch's CUDA and the driver's CUDA version (the loop graphs'
              conditional nodes need 12.4);
2. build    — every CUDA source of the port built with ``nvcc`` (in
              parallel) into ``build/kernels/``;
3. kernels  — each kernel wrapper against its plain PyTorch version at the
              serving shapes plus a sweep (rectify also through its
              one-column path, one device kernel a call), with its
              stated tolerance, and timed (median of CUDA-event timings) beside the plain
              version, one library call where one computes the same
              function, and its bound (bytes or operations at the H100's
              published peaks); flash over every case at every compiled
              head dim through both routes (bf16: the tensor-core kernel,
              f32: the CUDA-core kernel), ``ssd_chunk`` also at H 1, 3
              and 80 with Lc 1, 64, 100 and 256; rmsnorm through both
              variants and at the three served widths beside
              ``F.rms_norm``, as wrapper time and as device time per call
              (profiler); the accept kernel's sums bitwise equal between
              launches and to its summation order emulated in plain torch,
              and exactly one device kernel a call; the device loop's
              condition kernel exactly equal to its plain version;
4. parity   — the serving path on the card against the same path on the
              CPU on a closed-form drift (scheduling exact, samples 1e-4);
5. drift    — ``chords-dit-xl`` at full width and depth, random weights
              from a seeded generator, bf16: ``denoise`` with the kernels
              against the plain versions on a [32, 64, 16] batch;
6. serve    — the launcher defaults (latent (1, 64, 16), K=8, S=4, N=50,
              rtol 0.05, FIFO): 8 requests through ``ContinuousEngine`` and
              4 through ``ChordsEngine``, both with ``use_kernel(s)=True``;
              the launch counters, reset just before each engine runs,
              show that every kernel ran on its path; then a few rounds of
              a full grid under ``torch.profiler`` say where a round's
              device time goes and how long the device sits idle (each
              backbone kernel must show under its name with the launches
              the counters predict, the accept kernel once a round, and the
              round body's accept call must launch exactly one device
              kernel), and one
              profiled ``ChordsEngine`` batch gives the device time of its
              rectify kernel (one device kernel a round, and a call of
              the round body's step must launch exactly one);
7. overlap-serve — the SLA trace (``serve/sched/workload.py``: bulk
              requests, then urgent and soft ones with deadlines arriving
              mid-run) at the same size, through the synchronous and the
              overlap engine (``overlap=True``), FIFO and EDF-preempt, rtol
              0 and 0.05: samples bitwise equal per request, equal rounds,
              latencies and deadline counts, fewer readbacks, launch
              counts of every dispatched round, and no synchronizing call
              between speculating and verifying, counted twice
              (``torch.cuda.set_sync_debug_mode("error")``, and the CUDA
              runtime calls the profiler records inside those windows); then
              the device idle share of each mode from a profiled window;
8. ssd      — one ``zamba2-2.7b`` Mamba2 layer at full width (d_model
              2560), f32, B=2, 512 tokens (two chunks of 256, so the
              inter-chunk recurrence runs on the card): the kernel
              arrangement against the plain scan body;
9. hybrid-drift — ``zamba2-2.7b`` at full width and all 54 layers, random
              bf16 weights from a seeded generator: ``denoise`` with the
              kernels against the plain versions on a [32, 64, 16] batch
              (relative L2 error), exact launch counts per call; and an f32
              check at full width and 6 layers (one group);
10. hybrid-serve — phase 6 with the hybrid drift (launch counts of all five
              kernels, profile);
11. device-loop — the multi-round device loop on ``chords-dit-xl``: the
              launcher defaults through the synchronous loop at R=1 (eager
              and CUDA graphs) and R=8 (graphs), samples bitwise, equal
              rounds, at most half as many readbacks; the SLA and rollback
              traces through the overlap loop at R=8 against R=1; the
              round graph's nodes (kernel nodes equal to the eager round's
              profiled launches, the port's kernels among them); a steady
              window of eager R=1, graph R=1 and graph R=8 in each loop
              (s and device ms a round, idle share); capture time and memory;
12. elastic-serve — elastic capacity on ``chords-dit-xl`` (min 1, max 4
              slots, hysteresis 4, rtol 0) over ``bursty_trace(50, burst=4,
              quiet=2)``: synchronous at R=1 (every lane migration held to
              a bitwise row copy) and R=8, the overlap loop at R=1 (its
              trace written and passed by ``repro_torch.obs.check``);
              pinned min = max = 4 bitwise fixed S=4; each request's rounds
              and core equal fixed S=4's, samples bitwise when the drift is
              row independent across the buckets' row counts (probed op by
              op), else within the bf16 backbone tolerance with the gap
              printed; fewer wasted slot-rounds than fixed S=4; each
              bucket's capture time, the ladder's memory, and s a round
              and device idle share at S = 1, 2, 4;
13. lane-serve — heterogeneous lanes on ``chords-dit-xl``, 8 requests at
              S=4, the default lane profile: exact mode bitwise the
              homogeneous grid, adaptive and draft (rtol 0.05, tau 0.4)
              bitwise between graphs and eager programs with their skips
              and rounds, adaptive at rtol 0 bitwise exact, one accept and
              the backbone's per-call kernels a lane round;
14. hybrid-device-loop — phase 11 on ``zamba2-2.7b``;
15. stream-loop — the batch stream program (``ChordsEngine``, max_batch
              4, latent (1, 64, 16), K=8, N=50, rtol 0.05 and 0) as one
              CUDA graph with a device-side exit against the eager program:
              samples bitwise, equal rounds and cores, readbacks a call (1
              against one a round), s a round and device idle share of
              both, the step kernel's device-counted launches equal to the
              rounds, and the WHILE loop against replays of its round graph
              over windows of equal length;
16. baselines — the paper's ParaDiGMS (window 8) and SRDS (5 segments) on
              ``chords-dit-xl`` at full width and depth, kernels against
              the plain drift: rounds, speedup N / rounds, s a round;
17. train-denoiser — (a) the reduced denoiser of
              ``examples/torch_train_denoiser.py`` trained on the card
              (AdamW, checkpoints; the restore bitwise), then CHORDS,
              ParaDiGMS and SRDS against the sequential solve on it
              (speedup, latent RMSE); (b) ``chords-dit-xl``'s full widths
              cut to 4 layers, 10 AdamW steps on one fixed batch in bf16
              (loss finite and falling, s a step, peak memory); (c) one f32
              train step of the micro config, card against CPU;
18. lm-generate — LM serving through ``repro_torch.serve``'s prefill and
              KV-cache greedy decode at full width and depth
              (``gemma-7b``, ``qwen2-vl-7b``, ``olmoe-1b-7b``, one at a
              time; random bf16 weights from seed 0, the norm weights
              drawn off 1; batch 4, prompts of 512 ids from seed 1,
              ``max_len`` 1024, 64 decode steps):
              kernels against plain, teacher-forced, within relative L2
              2e-2 on every step's logits (top-1 agreement reported),
              launches exact (2·L rmsnorm and L flash a prefill, 2·L
              rmsnorm a decode step, none for the MoE), tokens bitwise on a
              second run; ms a prefill (and its device time by kernel), ms
              a decode step, tokens/s, host ms and device idle share a
              step (profiler), memory; then the seven reduced LM configs
              card (kernels, f32) against CPU: prefill 2e-5, decode 2e-3
              (both read the bf16 cache). The kernels phase adds the LM
              prefill shapes to flash's sweep (causal GQA group 7 and 2,
              Dh 256), timed beside SDPA, and the LM rmsnorm shapes to
              rmsnorm's.

On the card every serving engine runs on CUDA graphs (``serve/graphs.py``)
unless a phase asks for the eager programs. Launch counts are taken by the
kernels themselves on the device (``kernels.launch_counts``), so they count
what ran, graph replays included, and are held to the rounds the engine
says it dispatched.

The line before the last holds ``{"kernels": [...]}``; the line before that
the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. With no GPU, or without the repository's
``src/`` beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "parity", "drift", "serve",
          "overlap-serve", "device-loop", "elastic-serve", "lane-serve",
          "stream-loop", "baselines", "ssd", "hybrid-drift", "hybrid-serve",
          "hybrid-device-loop", "train-denoiser", "lm-generate")

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def median_ms(fn, iters: int = 10, reps: int = 10, warmup: int = 3) -> float:
    """Median over ``iters`` CUDA-event timings of ``reps`` back-to-back
    calls, per call (the host's launch cost included where it exceeds the
    kernel's: these per-round kernels are that small)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


# host seconds between a profiler window's edges and its device work. The
# profiler keeps a kernel only if its device timestamp falls inside the
# window's span on the host clock, and on the H100 host that timestamp
# read up to 0.70 ms behind the host's clock (a kernel stamped before its
# own launch), so kernels run just after the window opened were dropped
# (``benchmarks/torch_kernel_ablation.py profiler``: the first two calls
# of a window without the gap, none in 90 windows with it).
GAP_S = 0.005

# launches of a primer kernel (``torch.cuda._sleep``'s spin kernel) that
# open every recorded window, before its gap. Once the serve phase has run,
# the profiler keeps no kernel record of a window's first launches,
# although their launch records are there and the kernels ran: the first 4
# of 20 in 11 of 12 windows opened without a warm-up window, for the accept
# wrapper and ``torch.add`` alike, none in 12 opened with the primer
# (``benchmarks/torch_kernel_ablation.py profiler-serve``); with the
# warm-up window alone a whole smoke once lost 3 of 20 in each of three
# windows. The primer's records are dropped by name (:func:`_device_events`).
PRIME_LAUNCHES = 32
PRIME_TAG = "spin_kernel"


def _prime():
    import torch
    for _ in range(PRIME_LAUNCHES):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def profiled(warm, body, raw: bool = False):
    """``warm()`` in a warm-up window, then ``body()`` in the recorded one,
    each followed by a synchronize, under ``torch.profiler``; the recorded
    window opens with ``PRIME_LAUNCHES`` primer launches, then the host
    waits ``GAP_S``, and again before the window closes. Returns the device
    events of ``body`` (``raw``: the profiler itself)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        _prime()
        time.sleep(GAP_S)
        body()
        torch.cuda.synchronize()
        time.sleep(GAP_S)
    return prof if raw else _device_events(prof)


def device_ms(fn, calls: int = 20):
    """Device time per call of ``fn`` from a ``torch.profiler`` window over
    ``calls`` calls (see :func:`profiled`), with the kernels it launched:
    (ms per call, kernel launches per call, kernel names)."""
    def body():
        for _ in range(calls):
            fn()
    events = profiled(body, body)
    return (sum(e.self_device_time_total for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls,
            sorted({e.key[:60] for e in events}))


def graph_kernel_nodes(fn) -> int:
    """Kernel nodes of a CUDA graph captured from one call of ``fn``: the
    device kernels a call enqueues, counted without the profiler
    (:func:`graph_nodes`)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    kernels = graph_nodes(g.raw_cuda_graph())["types"].get("kernel", 0)
    g.reset()
    return kernels


# profiler windows a one-kernel check may open: the profiler still loses a
# kernel record now and then with the gap (a window of 20 accept calls once
# read 19 while nothing else was wrong), so a window that recorded fewer
# kernels than the kernels' own device counters counted in it is opened
# again; any other disagreement fails at once
ONE_KERNEL_WINDOWS = 3


def check_one_kernel(what: str, tag: str, fn, calls: int = 20) -> dict:
    """One device kernel a call of ``fn``, counted three times: the port's
    kernels count exactly one launch a call on the device
    (``kernels.launch_counts``), a CUDA graph captured from one call holds
    exactly one kernel node, and a profiler window shows ``tag``'s kernel
    and no other (a cast or a second pass would show by its name) exactly
    once a call. A window whose records fall short of the device's count
    lost them in the profiler and is opened again (``ONE_KERNEL_WINDOWS``).
    Returns the exact window's device time a call."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nodes = graph_kernel_nodes(fn)
    lost = []
    for _ in range(ONE_KERNEL_WINDOWS):
        reset_launch_counts()
        ms, per_call, names = device_ms(fn, calls)
        # the window's warm-up runs the calls too
        ran = sum(launch_counts().values()) / (2 * calls)
        if per_call >= 1 or ran != 1 or nodes != 1 or not names \
                or not all(tag in n for n in names):
            break
        lost.append(round(calls * (1 - per_call)))
        emit("profiler-loss", what=what, calls=calls,
             kernels_recorded=round(calls * per_call),
             device_launches=calls)
    if per_call != 1 or ran != 1 or nodes != 1 or not names \
            or not all(tag in n for n in names):
        raise AssertionError(f"{what}: {per_call} device kernels a call "
                             f"({names}) in the profiler, {ran} launches a "
                             f"call on the device's counters, {nodes} "
                             f"kernel nodes in a graph of one call, want "
                             f"one {tag} (records lost by earlier "
                             f"windows: {lost})")
    return {"kernels_per_call": per_call, "device_launches_per_call": ran,
            "graph_kernel_nodes": nodes, "device_ms": ms, "names": names,
            "profiler_records_lost": lost}


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).norm() / b.norm()))


# -- phase 1 ------------------------------------------------------------------

CARD = [""]  # the nvidia-smi name and power limit, set by phase_device


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    try:
        nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
        nvcc = nvcc.splitlines()[-1]
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"nvcc --version failed: {e}")
    import ctypes
    drv = ctypes.c_int(0)
    if ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(drv)):
        raise RuntimeError("cuDriverGetVersion failed")
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, driver_cuda=drv.value, nvcc=nvcc,
         nvidia_smi=smi.stdout.strip().splitlines()[0])
    CARD[0] = smi.stdout.strip().splitlines()[0]
    return CARD[0]


def _nvcc():
    from repro_torch.kernels.build import find_nvcc
    return find_nvcc()


# -- phase 2 ------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    secs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         dir=str(build.build_dir()))


# -- phase 3 ------------------------------------------------------------------

def _rectify_operands(rows, m, p, gen):
    import torch
    dev = "cuda"
    lat = [torch.randn(rows, m, generator=gen, device=dev) for _ in range(6)]
    prev = torch.randn(p, m, generator=gen, device=dev)
    dt = torch.rand(rows, generator=gen, device=dev)
    ds = torch.rand(rows, generator=gen, device=dev)
    fire = torch.rand(rows, generator=gen, device=dev) < 0.5
    return lat, prev, dt, ds, fire


def check_rectify(gen, records):
    """Both rectify kernels against their plain versions: ``out`` bitwise;
    the accept sums within rtol 1e-5 of the plain version, bitwise equal
    between two launches and to the kernel's summation order emulated in
    plain torch (``accept_sums_in_kernel_order``); timed at the serving
    shape, where the accept wrapper must launch exactly one kernel."""
    import torch
    from repro_torch.kernels.rectify import kernel as K
    from repro_torch.kernels.rectify.ref import (
        accept_sums_in_kernel_order, fused_step_rectify_accept_ref,
        fused_step_rectify_ref)
    results = []
    # (rows, M, prev rows): the serving grid S*K=32 rows of M = 1*64*16,
    # prev shared by each slot's 8 cores; a per-row prev; a long tail
    for rows, m, p in ((32, 1024, 4), (32, 1024, 32), (64, 1_000_003, 64)):
        lat, prev, dt, ds, fire = _rectify_operands(rows, m, p, gen)
        out = K.fused_step_rectify(*lat, dt, ds, fire)
        ref = fused_step_rectify_ref(*lat, dt, ds, fire)
        # the step kernel's one-column path: views 4 bytes off alignment
        views = [torch.cat((t.new_zeros(1), t.flatten()))[1:].view(rows, m)
                 for t in lat]
        out1 = K.fused_step_rectify(*views, dt, ds, fire)
        if not (torch.equal(out, ref) and torch.equal(out1, ref)):
            raise AssertionError(f"rectify [{rows},{m}] not bitwise: max "
                                 f"err {max_err(out, ref)}, unaligned "
                                 f"{max_err(out1, ref)}")
        out2, e2, o2 = K.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
        _, e3, o3 = K.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
        ref2, re2, ro2 = fused_step_rectify_accept_ref(*lat, prev, dt, ds,
                                                       fire)
        plan = K.accept_plan(rows, m, True)
        ke, ko = accept_sums_in_kernel_order(ref2, prev, *plan)
        torch.cuda.synchronize()
        if not torch.equal(out2, ref2):
            raise AssertionError(f"rectify accept [{rows},{m}] out not "
                                 f"bitwise: {max_err(out2, ref2)}")
        for a, b in ((e2, re2), (o2, ro2)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
        if not (torch.equal(e2, e3) and torch.equal(o2, o3)):
            raise AssertionError(f"rectify accept [{rows},{m}]: sums differ "
                                 f"between two launches")
        results.append({"rows": rows, "m": m, "prev_rows": p,
                        "step_plans": [K.step_plan(rows, m, True)._asdict(),
                                       K.step_plan(rows, m, False)._asdict()],
                        "plan": plan._asdict(), "out_bitwise": True,
                        "sums_repeat_bitwise": True,
                        "sums_kernel_order_bitwise": bool(
                            torch.equal(e2, ke) and torch.equal(o2, ko)),
                        "sum_rel_err": max(
                            float(((e2 - re2).abs() / re2.abs()).max()),
                            float(((o2 - ro2).abs() / ro2.abs()).max()))})

    # timing at the serving shape
    rows, m, p = 32, 1024, 4
    lat, prev, dt, ds, fire = _rectify_operands(rows, m, p, gen)
    ms = median_ms(lambda: K.fused_step_rectify(*lat, dt, ds, fire))
    plain = median_ms(lambda: fused_step_rectify_ref(*lat, dt, ds, fire))
    err = max_err(K.fused_step_rectify(*lat, dt, ds, fire),
                  fused_step_rectify_ref(*lat, dt, ds, fire))
    nbytes = 4 * (7 * rows * m + 3 * rows)
    bms, by = bound_ms(nbytes, 7 * rows * m, "float32")
    one = check_one_kernel("rectify", "step_rectify_kernel",
                           lambda: K.fused_step_rectify(*lat, dt, ds, fire))
    records["fused_step_rectify"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=err, shape=[rows, m], device_ms=one["device_ms"],
        kernels_per_call=one["kernels_per_call"],
        graph_kernel_nodes=one["graph_kernel_nodes"],
        kernel_names=one["names"], plan=K.step_plan(rows, m, True)._asdict())
    ms = median_ms(lambda: K.fused_step_rectify_accept(*lat, prev, dt, ds,
                                                       fire))
    plain = median_ms(lambda: fused_step_rectify_accept_ref(
        *lat, prev, dt, ds, fire))
    a = K.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
    b = fused_step_rectify_accept_ref(*lat, prev, dt, ds, fire)
    err = max(max_err(x, y) for x, y in zip(a, b))
    nbytes = 4 * (7 * rows * m + p * m + 5 * rows)
    bms, by = bound_ms(nbytes, 12 * rows * m, "float32")
    one = check_one_kernel(
        "rectify accept", "step_rectify_accept_kernel",
        lambda: K.fused_step_rectify_accept(*lat, prev, dt, ds, fire))
    records["fused_step_rectify_accept"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=err, shape=[rows, m, p], device_ms=one["device_ms"],
        kernels_per_call=one["kernels_per_call"],
        graph_kernel_nodes=one["graph_kernel_nodes"],
        plan=K.accept_plan(rows, m, True)._asdict())
    emit("kernels/rectify", cases=results,
         timings={k: records[k] for k in ("fused_step_rectify",
                                          "fused_step_rectify_accept")})


# rmsnorm at the served widths: the DiT's 3072, the hybrid's 2560 and the
# 5120 of its shared block's ln_in (concat(h, h0)); 2048 rows = S*K*64
RMSNORM_SERVING = ((2048, 3072), (2048, 2560), (2048, 5120))


def check_rmsnorm(gen, records):
    """rmsnorm against its plain version (1e-5 f32, 5e-2 bf16) through both
    variants (rows in registers; two sweeps for 5120 f32), 16-byte vectors
    and one element at a time (an odd width, an unaligned view); then, at
    each served width, the wrapper timed as ``F.rms_norm`` is (``median_ms``,
    host cost included) and both by device time per call (profiler)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for rows, d, dt, wdt, offset in ((2048, 3072, bf, bf, 0),
                                     (2048, 3072, bf, f32, 0),
                                     (2048, 2560, bf, bf, 0),
                                     (2048, 5120, bf, bf, 0),
                                     (1000, 3072, f32, f32, 0),
                                     (1000, 5120, f32, f32, 0),
                                     (37, 128, f32, f32, 0),
                                     (333, 4096, bf, bf, 0),
                                     (333, 1001, bf, bf, 0),
                                     (333, 2560, bf, bf, 1),
                                     (333, 3072, f32, f32, 1),
                                     # phase lm-generate: the qwen2-vl
                                     # prefill, the gemma and qwen2-vl
                                     # decode steps, the reduced configs'
                                     # prefill and decode
                                     (2048, 3584, bf, bf, 0),
                                     (4, 3072, bf, bf, 0),
                                     (4, 3584, bf, bf, 0),
                                     (154, 64, f32, f32, 0),
                                     (2, 64, f32, f32, 0)):
        tol = 1e-5 if dt == f32 else 5e-2
        flat = torch.randn(rows * d + offset, generator=gen, device="cuda")
        x = flat.to(dt)[offset:].view(rows, d)   # offset 1: not 16-aligned
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")) \
            .to(wdt)
        out, ref = K.rmsnorm(x, w), rmsnorm_ref(x, w)
        err = max_err(out, ref)
        if not err <= tol:
            raise AssertionError(f"rmsnorm {rows}x{d} {dt} offset {offset}: "
                                 f"err {err} > {tol}")
        plan = K.plan(d, dt, (x.data_ptr() | w.data_ptr()) % 16 == 0)
        cases.append({"rows": rows, "d": d, "dtype": str(dt),
                      "w_dtype": str(wdt), "offset": offset,
                      "plan": plan._asdict(), "max_abs_err": err, "tol": tol})
    emit("kernels/rmsnorm", cases=cases)
    for rows, d in RMSNORM_SERVING:
        x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")) \
            .bfloat16()
        ms = median_ms(lambda: K.rmsnorm(x, w))
        lib = median_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
        dev, per_call, _ = device_ms(lambda: K.rmsnorm(x, w))
        lib_dev, lib_per_call, lib_names = device_ms(
            lambda: F.rms_norm(x, (d,), w, 1e-6))
        bms, by = bound_ms(2 * (2 * rows * d + d), 4 * rows * d, "bfloat16")
        rec = dict(shape=[rows, d], ms=ms, library_ms=lib, device_ms=dev,
                   library_device_ms=lib_dev,
                   library_kernels_per_call=lib_per_call,
                   library_kernels=lib_names, kernels_per_call=per_call,
                   bound_ms=bms, bound_by=by, bound_share=bms / dev,
                   wrapper_within_library=ms <= lib,
                   plan=K.plan(d, torch.bfloat16, True)._asdict())
        if (rows, d) == RMSNORM_SERVING[0]:
            rec.update(plain_ms=median_ms(lambda: rmsnorm_ref(x, w)),
                       max_abs_err=max_err(K.rmsnorm(x, w),
                                           rmsnorm_ref(x, w)))
            records["rmsnorm"] = rec
        emit("kernels/rmsnorm-timing", **rec)


def _flash_flops(b, sq, sk, h, dh, causal):
    if not causal:
        return 4.0 * b * h * sq * sk * dh
    pairs = sum(min(q + 1, sk) for q in range(sq))
    return 4.0 * b * h * pairs * dh


def check_flash(gen, records):
    """Every case of the sweep at every compiled head dim, through both
    routes: bf16 (the tensor-core kernel) within 2e-2 and f32 (the
    CUDA-core kernel) within 2e-5 of the plain version; both routes timed
    at the DiT shape, the bf16 route also at the hybrid's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cases = []
    sweep = [  # (b, sq, sk, h, kv, causal), each at every head dim
        (32, 64, 64, 24, 24, False),    # the DiT serving shape
        (32, 64, 64, 32, 32, True),     # the hybrid's shared block
        (2, 1024, 1024, 24, 24, False),
        (2, 1024, 1024, 24, 8, True),   # GQA, causal, many KV tiles
        (2, 200, 200, 24, 8, True),     # tails
        (3, 200, 333, 4, 2, False),
        (4, 77, 77, 4, 4, True),
        (2, 64, 64, 4, 4, False),
    ]
    for b, sq, sk, h, kv, causal in sweep:
        for dh in K.HEAD_DIMS:
            for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                q = torch.randn(b, sq, h, dh, generator=gen, device="cuda") \
                    .to(dt)
                k = torch.randn(b, sk, kv, dh, generator=gen, device="cuda") \
                    .to(dt)
                v = torch.randn(b, sk, kv, dh, generator=gen, device="cuda") \
                    .to(dt)
                out = K.flash_attention(q, k, v, causal=causal)
                ref = attention_ref(q, k, v, causal)
                err = max_err(out, ref)
                if not err <= tol:
                    raise AssertionError(
                        f"flash {(b, sq, sk, h, kv, dh, causal)} {dt}: err "
                        f"{err} > {tol}")
                cases.append({"shape": [b, sq, sk, h, kv, dh],
                              "causal": causal, "dtype": str(dt),
                              "max_abs_err": err, "tol": tol})
    b, s, h, dh = 32, 64, 24, 128
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    ms = median_ms(lambda: K.flash_attention(q, k, v, causal=False))
    plain = median_ms(lambda: attention_ref(q, k, v, False))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bms, by = bound_ms(2 * 4 * b * s * h * dh,
                       _flash_flops(b, s, s, h, dh, False), "bfloat16")
    records["flash_attention"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
        max_abs_err=max_err(K.flash_attention(q, k, v, causal=False),
                            attention_ref(q, k, v, False)),
        shape=[b, s, h, dh])
    # the f32 route (CUDA-core kernel) at the same shape
    q, k, v = (t.float() for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    f32 = dict(
        shape=[b, s, h, dh], dtype="float32",
        ms=median_ms(lambda: K.flash_attention(q, k, v, causal=False)),
        plain_ms=median_ms(lambda: attention_ref(q, k, v, False)),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt)))
    f32["bound_ms"], f32["bound_by"] = bound_ms(
        4 * 4 * b * s * h * dh, _flash_flops(b, s, s, h, dh, False),
        "float32")
    # the hybrid's shape (causal, Dh 80), reported beside the record
    b, s, h, dh = 32, 64, 32, 80
    q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    hybrid = dict(
        shape=[b, s, h, dh], causal=True,
        ms=median_ms(lambda: K.flash_attention(q, k, v, causal=True)),
        plain_ms=median_ms(lambda: attention_ref(q, k, v, True)),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))
    hybrid["bound_ms"], hybrid["bound_by"] = bound_ms(
        2 * 4 * b * s * h * dh, _flash_flops(b, s, s, h, dh, True),
        "bfloat16")
    # head dim 256 (gemma-7b's attention: 16 heads of 256), causal, both
    # routes; no served path reaches it yet
    b, s, h, dh = 2, 1024, 16, 256
    dh256 = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
                   .to(dt) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        name = str(dt).split(".")[-1]
        rec = dict(
            shape=[b, s, h, dh], causal=True,
            max_abs_err=max_err(K.flash_attention(q, k, v, causal=True),
                                attention_ref(q, k, v, True)),
            ms=median_ms(lambda: K.flash_attention(q, k, v, causal=True)),
            plain_ms=median_ms(lambda: attention_ref(q, k, v, True)),
            library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * q.element_size() * b * s * h * dh,
            _flash_flops(b, s, s, h, dh, True), name)
        dh256[name] = rec
    emit("kernels/flash_attention", cases=cases, f32_route=f32,
         hybrid_shape=hybrid, head_dim_256=dh256,
         lm_prefill=check_flash_lm(gen))


# the LM prefill shapes at phase lm-generate's traffic, causal: (b, s, h,
# kv, dh) of qwen2-vl-7b (GQA group 7), internlm2-1.8b (group 2) and
# gemma-7b (Dh 256)
LM_FLASH = {"qwen2-vl-7b": (4, 512, 28, 4, 128),
            "internlm2-1.8b": (4, 512, 16, 8, 128),
            "gemma-7b": (4, 512, 16, 16, 256)}


def check_flash_lm(gen):
    """The LM prefill shapes through both routes within the kernel
    tolerances (bf16 2e-2, f32 2e-5); the qwen2-vl and gemma shapes timed
    beside the plain version and SDPA (``enable_gqa``), with the kernel's
    device time per launch and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref
    out = {}
    for name, (b, s, h, kv, dh) in LM_FLASH.items():
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            q = torch.randn(b, s, h, dh, generator=gen, device="cuda").to(dt)
            k, v = (torch.randn(b, s, kv, dh, generator=gen, device="cuda")
                    .to(dt) for _ in range(2))
            err = max_err(K.flash_attention(q, k, v, causal=True),
                          attention_ref(q, k, v, True))
            if not err <= tol:
                raise AssertionError(f"flash {name} {(b, s, h, kv, dh)} "
                                     f"{dt}: err {err} > {tol}")
            rec = dict(shape=[b, s, s, h, kv, dh], causal=True,
                       dtype=str(dt).split(".")[-1], max_abs_err=err,
                       tol=tol)
            if name != "internlm2-1.8b":
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                rec.update(
                    ms=median_ms(lambda: K.flash_attention(q, k, v,
                                                           causal=True)),
                    device_ms=device_ms(lambda: K.flash_attention(
                        q, k, v, causal=True))[0],
                    plain_ms=median_ms(lambda: attention_ref(q, k, v, True)),
                    library_ms=median_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True)))
                rec["bound_ms"], rec["bound_by"] = bound_ms(
                    q.element_size() * 2 * b * s * (h + kv) * dh,
                    _flash_flops(b, s, s, h, dh, True), rec["dtype"])
            out[f"{name}/{rec['dtype']}"] = rec
    return out


def _ssd_operands(g, h, lc, n, hd, gen):
    """Random C/B/xdt and a non-increasing cum, as the JAX sweep draws
    them (``tests/test_kernels.py``)."""
    import torch
    c, b = (torch.randn(g, lc, n, generator=gen, device="cuda")
            for _ in range(2))
    xdt = torch.randn(g, h, lc, hd, generator=gen, device="cuda")
    cum = -torch.randn(g, h, lc, generator=gen, device="cuda").abs() \
        .cumsum(-1)
    return c, b, xdt, cum


def _ssd_cost(g, h, lc, n, hd):
    """(bytes, FLOPs) the function needs: C/B, xdt, cum read once, y and s
    written once; C·Bᵀ over the causal pairs once per g (it is shared by
    the H heads), then per (g, h) the decay mask product, P·xdt, xdt·w and
    (xdt·w)ᵀ·B. Exponentials are not counted."""
    pairs = lc * (lc + 1) // 2
    nbytes = 4 * (2 * g * lc * n + 2 * g * h * lc * hd + g * h * lc
                  + g * h * hd * n)
    flops = (2 * g * pairs * n + g * h * pairs + 2 * g * h * pairs * hd
             + g * h * lc * hd + 2 * g * h * lc * hd * n)
    return nbytes, flops


def check_ssd(gen, records):
    """``ssd_chunk`` against its plain version: the JAX sweep at atol 1e-4;
    the serving shape, a full 256-row chunk and a 100-row tail at
    max(1e-4, 1e-5 * max|ref|) — there the outputs reach tens to hundreds,
    the two versions sum up to Lc*N f32 products in different orders, and
    1e-5 of the largest output is ~84 of its ulps."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref
    cases = []
    shapes = [((2, 2, 16, 8, 8), "sweep"),
              ((1, 4, 32, 16, 16), "sweep"),
              ((3, 1, 64, 32, 8), "sweep"),
              ((32, 80, 64, 64, 64), "serving"),
              ((4, 80, 256, 64, 64), "full chunk"),
              ((3, 4, 100, 16, 16), "tail")]
    # head groups down to one head (H = 1), a group the launcher's pick
    # need not divide (H = 3), and Lc from one row to a full chunk
    shapes += [((3 if h < 80 else 4, h, lc, 64, 64), "heads/rows")
               for h in (1, 3, 80) for lc in (1, 64, 100, 256)]
    for shape, kind in shapes:
        ops = _ssd_operands(*shape, gen)
        out = K.ssd_chunk(*ops)
        ref = ssd_chunk_batched_ref(*ops)
        torch.cuda.synchronize()
        case = {"shape": list(shape), "kind": kind,
                "bitwise": all(torch.equal(o, r) for o, r in zip(out, ref))}
        for name, o, r in zip(("y", "s"), out, ref):
            scale = float(r.abs().max())
            tol = 1e-4 if kind == "sweep" else max(1e-4, 1e-5 * scale)
            err = max_err(o, r)
            if not err <= tol:
                raise AssertionError(f"ssd_chunk {shape} {name}: err {err} "
                                     f"> {tol} (max|ref| {scale})")
            case[name] = {"max_abs_err": err, "max_abs_ref": scale,
                          "tol": tol}
        cases.append(case)
    shape = (32, 80, 64, 64, 64)
    ops = _ssd_operands(*shape, gen)
    ms = median_ms(lambda: K.ssd_chunk(*ops))
    plain = median_ms(lambda: ssd_chunk_batched_ref(*ops))
    nbytes, flops = _ssd_cost(*shape)
    bms, by = bound_ms(nbytes, flops, "float32")
    err = max(max_err(o, r) for o, r in zip(K.ssd_chunk(*ops),
                                            ssd_chunk_batched_ref(*ops)))
    # no single PyTorch call computes this function: library_ms is null
    records["ssd_chunk"] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                bound_by=by, library_ms=None,
                                max_abs_err=err, shape=list(shape))
    emit("kernels/ssd_chunk", cases=cases,
         bound={"bytes": nbytes, "flops": flops, "launches_per_round": 54,
                "round_bound_ms": 54 * bms})


def check_device_loop(gen, records):
    """The device loop's condition kernel against its plain version on
    random flags at S 1, 4 (the serving grid), 64 and 4096, entry and eight
    steps each, multi and roll: ``ctrl``, ``done0`` and the condition
    exactly equal; timed at S=4 as one standalone launch (in the loop
    programs it is a graph node), one device kernel a call."""
    import torch
    from repro_torch.kernels.device_loop.kernel import loop_step
    from repro_torch.kernels.device_loop.ref import (EXIT_ON_ACCEPT, FIRST,
                                                     loop_step_ref)
    cases = []
    for s in (1, 4, 64, 4096):
        for flags in (EXIT_ON_ACCEPT, 0):
            live = torch.rand(s, generator=gen, device="cuda") < 0.5
            done = torch.rand(s, generator=gen, device="cuda") < 0.3
            d0k, d0r = (torch.zeros(s, dtype=torch.bool, device="cuda")
                        for _ in range(2))
            ck, cr = (torch.tensor([6, 0, 0, 0], dtype=torch.int32,
                                   device="cuda") for _ in range(2))
            conds = []
            for i in range(9):
                f = flags | (FIRST if i == 0 else 0)
                gk = int(loop_step(live, done, d0k, ck, f))
                gr = int(loop_step_ref(live, done, d0r, cr, f))
                if gk != gr or not (torch.equal(ck, cr)
                                    and torch.equal(d0k, d0r)):
                    raise AssertionError(f"device loop S={s} flags {f} "
                                         f"step {i}: {ck.tolist()} vs "
                                         f"{cr.tolist()}")
                conds.append(gk)
                live = live & (torch.rand(s, generator=gen, device="cuda")
                               < 0.85)
                done = done | (torch.rand(s, generator=gen, device="cuda")
                               < 0.05)
            cases.append({"s": s, "flags": flags, "conditions": conds})
    s = 4
    live = torch.ones(s, dtype=torch.bool, device="cuda")
    done = torch.zeros(s, dtype=torch.bool, device="cuda")
    d0 = torch.zeros(s, dtype=torch.bool, device="cuda")
    ctrl = torch.tensor([1 << 30, 0, 0, 0], dtype=torch.int32, device="cuda")
    loop_step(live, done, d0, ctrl, EXIT_ON_ACCEPT | FIRST)
    ms = median_ms(lambda: loop_step(live, done, d0, ctrl, EXIT_ON_ACCEPT))
    plain = median_ms(lambda: loop_step_ref(live, done, d0, ctrl,
                                            EXIT_ON_ACCEPT))
    # live, done, done0 read once, three control words read and three
    # written; ~3 operations a slot
    bms, by = bound_ms(3 * s + 24, 3 * s, "float32")
    one = check_one_kernel("device loop", "device_loop_kernel",
                           lambda: loop_step(live, done, d0, ctrl,
                                             EXIT_ON_ACCEPT))
    records["device_loop"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=0.0, shape=[s], device_ms=one["device_ms"],
        kernels_per_call=one["kernels_per_call"],
        graph_kernel_nodes=one["graph_kernel_nodes"])
    emit("kernels/device_loop", cases=cases, timing=records["device_loop"])


def phase_kernels(records):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_rectify(gen, records)
    check_rmsnorm(gen, records)
    check_flash(gen, records)
    check_ssd(gen, records)
    check_device_loop(gen, records)
    emit("kernels", timings={k: {f: v[f] for f in ("ms", "plain_ms",
                                                    "library_ms", "bound_ms",
                                                    "bound_by")}
                             for k, v in records.items()})


def phase_parity():
    """The serving path on the card against the same path on the CPU (the
    plain versions), on a small closed-form drift: 8 requests (mixed
    priorities and tolerances) through ``ContinuousEngine`` with identical
    noise. Scheduling must agree
    exactly, samples within 1e-4."""
    import torch
    from repro_torch.core import GaussianMixture, uniform_tgrid
    from repro_torch.serve import ContinuousEngine, Request
    gen = torch.Generator().manual_seed(5)
    gm = GaussianMixture(4.0 * torch.randn(6, 16, generator=gen),
                         torch.full((6,), 0.25),
                         torch.softmax(torch.randn(6, generator=gen), 0))
    noise = [torch.randn(4, 16, generator=gen) for _ in range(8)]
    runs = {}
    for dev in ("cuda", "cpu"):
        g = gm.to(dev)
        engine = ContinuousEngine(g.drift, (4, 16), 50, 8,
                                  uniform_tgrid(50, 0.98), num_slots=4,
                                  use_kernel=True, device=dev)
        for i, x0 in enumerate(noise):
            engine.submit(Request(rid=i, x0=x0, priority=i % 2,
                                  rtol=(0.05, 0.01, 0.2, 0.0)[i % 4]))
        runs[dev] = (dict(engine.run_until_drained()), engine.stats())
    (gpu, st_g), (cpu, st_c) = runs["cuda"], runs["cpu"]
    if st_g["kernel_path"] != "fused-accept-cuda":
        raise AssertionError(f"kernel_path {st_g['kernel_path']}")
    err = 0.0
    for rid, o in cpu.items():
        if (gpu[rid].rounds_used, gpu[rid].accepted_core) != \
                (o.rounds_used, o.accepted_core):
            raise AssertionError(f"request {rid}: card {gpu[rid]} vs cpu {o}")
        err = max(err, max_err(gpu[rid].sample, o.sample))
    if not err <= 1e-4 or st_g["rounds_total"] != st_c["rounds_total"]:
        raise AssertionError(f"card vs cpu: max err {err}, rounds "
                             f"{st_g['rounds_total']} vs {st_c['rounds_total']}")
    emit("parity", requests=len(cpu), rounds=st_g["rounds_total"],
         rounds_used=[cpu[r].rounds_used for r in sorted(cpu)],
         max_abs_err=err)


# -- phases 5 to 9 -------------------------------------------------------------

def build_model(arch: str = "chords-dit-xl", seed: int = 0, **overrides):
    """Full-width config of ``arch`` (``overrides`` replace fields) with
    random weights from a seeded generator on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper
    cfg = get_config(arch).replace(**overrides)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_wrapper(cfg, 16, generator=gen, device="cuda")
    # the reference initializes out_proj to zeros (a zero drift); random
    # values make the smoke's drift, and so its sampling, non-trivial
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.02, generator=gen)
    return cfg, params


def per_call_launches(cfg) -> dict:
    """Backbone kernel launches of one drift call: the dense trunk runs
    ln1/ln2 per layer plus the final norm and one attention per layer; the
    hybrid one SSD chunk launch and one norm per Mamba2 layer, ln_in/ln1/ln2
    and one attention per shared-block invocation, and the final norm."""
    L = cfg.num_layers
    if cfg.family == "hybrid":
        g = L // cfg.attn_every
        return {"rmsnorm": L + 3 * g + 1, "flash_attention": g,
                "ssd_chunk": L}
    return {"rmsnorm": 2 * L + 1, "flash_attention": L, "ssd_chunk": 0}


def _drift_pair(cfg, params, x, t):
    """denoise with the kernels (launches counted) and with the plain
    versions on the same inputs."""
    import torch
    from repro_torch.diffusion import denoise
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    with torch.no_grad():
        out_k = denoise(params, cfg.replace(use_kernels=True), x, t)
        torch.cuda.synchronize()
        counts = launch_counts()
        out_p = denoise(params, cfg, x, t)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and out_k.shape == x.shape):
        raise AssertionError("drift output not finite or misshapen")
    want = per_call_launches(cfg)
    if any(counts[name] != c for name, c in want.items()):
        raise AssertionError(f"drift launch counts {counts}, want {want}")
    return out_k, out_p, counts


def phase_drift(cfg, params, phase="drift"):
    """The drift on a [32, 64, 16] batch, kernels vs plain. The dense
    trunk holds the reference's bf16 contract (rtol 8e-2, atol 5e-2). The
    hybrid's does not hold elementwise even between the JAX package's own
    two paths, so it is held to a relative L2 error <= 2e-2."""
    import torch
    from repro_torch.diffusion import denoise
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(32, 64, 16, generator=gen, device="cuda")
    t = torch.rand(32, generator=gen, device="cuda")
    out_k, out_p, counts = _drift_pair(cfg, params, x, t)
    err = rel_l2(out_k, out_p)
    if cfg.family == "hybrid":
        if not err <= 2e-2:
            raise AssertionError(f"{phase}: relative L2 error {err} > 2e-2")
    else:
        torch.testing.assert_close(out_k, out_p, rtol=8e-2, atol=5e-2)
    with torch.no_grad():
        t_k = median_ms(lambda: denoise(params, cfg.replace(use_kernels=True),
                                        x, t), iters=5, reps=1, warmup=1)
        t_p = median_ms(lambda: denoise(params, cfg, x, t), iters=5, reps=1,
                        warmup=1)
    emit(phase, arch=cfg.name, layers=cfg.num_layers, batch=list(x.shape),
         max_abs_err=max_err(out_k, out_p), rel_l2_err=err, kernels_ms=t_k,
         plain_ms=t_p, launches_per_call=counts,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         out_projection=out_projection_cost(cfg, params, x, t))


def out_projection_cost(cfg, params, x, t) -> dict:
    """The cost of computing the drift's f32 out-projection and time MLP in
    fixed pieces of rows (``wrapper.row_product``) rather than as one
    product each: the drift call on the full grid (a DiT round's drift)
    with each, in turns (one, pieces, pieces, one), and the out-projection
    alone at the grid's shape."""
    import torch
    from repro_torch.diffusion import denoise
    from repro_torch.diffusion import wrapper as W
    pieces = W.row_product

    def one(x, w, piece_rows):
        return x @ w

    kcfg = cfg.replace(use_kernels=True)
    ms = {"one_product": [], "pieces": []}
    with torch.no_grad():
        for label in ("one_product", "pieces", "pieces", "one_product"):
            W.row_product = one if label == "one_product" else pieces
            try:
                ms[label].append(median_ms(
                    lambda: denoise(params, kcfg, x, t), iters=5, reps=1,
                    warmup=1))
            finally:
                W.row_product = pieces
        gen = torch.Generator(device="cuda").manual_seed(11)
        hf = torch.randn(x.shape[0], x.shape[1], cfg.d_model, generator=gen,
                         device="cuda")
        w = torch.randn(cfg.d_model, x.shape[-1], generator=gen,
                        device="cuda")
        alone = {"one_product": median_ms(lambda: one(hf, w, 0)),
                 "pieces": median_ms(lambda: pieces(hf, w,
                                                    W.OUT_PIECE_ROWS))}
    return {"drift_ms": ms, "product_ms": alone,
            "rows": x.shape[0] * x.shape[1],
            "piece_rows": W.OUT_PIECE_ROWS, "card": CARD[0]}


def phase_hybrid_f32():
    """The hybrid at full width in f32, 6 layers (one group): kernels vs
    plain within a relative L2 error of 1e-4 (f32 sums reassociated by the
    kernels, through 6 layers)."""
    import torch
    cfg, params = build_model("zamba2-2.7b", num_layers=6,
                              param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(32, 64, 16, generator=gen, device="cuda")
    t = torch.rand(32, generator=gen, device="cuda")
    out_k, out_p, counts = _drift_pair(cfg, params, x, t)
    err = rel_l2(out_k, out_p)
    if not err <= 1e-4:
        raise AssertionError(f"hybrid f32: relative L2 error {err} > 1e-4")
    emit("hybrid-drift/f32", layers=cfg.num_layers, batch=list(x.shape),
         max_abs_err=max_err(out_k, out_p), rel_l2_err=err,
         max_abs_out=float(out_p.abs().max()), launches_per_call=counts)


def phase_ssd():
    """One full-width Mamba2 layer in f32 (B=2, 512 tokens: two chunks of
    256): the kernel arrangement against the plain scan body, y and the
    final state within a relative L2 error of 1e-5. A and dt follow
    Mamba2's initialization (A in [1, 16], dt in [0.001, 0.1], log-uniform)
    so that the decay carries state across the chunk boundary."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import mamba2 as M
    from repro_torch.utils.pspec import init_params
    cfg = get_config("zamba2-2.7b").replace(param_dtype="float32",
                                            compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = init_params(M.ssd_specs(cfg), gen, torch.float32, "cuda")
    h = M.num_ssm_heads(cfg)
    with torch.no_grad():
        u = torch.rand(2, h, generator=gen, device="cuda")
        p["a_log"].copy_(torch.log(1.0 + 15.0 * u[0]))
        dt = torch.exp(math.log(1e-3) + u[1] * math.log(100.0))
        p["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus⁻¹
    x = torch.randn(2, 512, cfg.d_model, generator=gen, device="cuda")
    with torch.no_grad():
        reset_launch_counts()
        y_k, (_, s_k) = M.ssd_forward(p, cfg.replace(use_kernels=True), x)
        torch.cuda.synchronize()
        launches = launch_counts()["ssd_chunk"]
        y_p, (_, s_p) = M.ssd_forward(p, cfg, x)
        torch.cuda.synchronize()
        t_k = median_ms(lambda: M.ssd_forward(
            p, cfg.replace(use_kernels=True), x), iters=5, reps=1)
        t_p = median_ms(lambda: M.ssd_forward(p, cfg, x), iters=5, reps=1)
    errs = {"y": rel_l2(y_k, y_p), "state": rel_l2(s_k, s_p)}
    if launches != 1 or not max(errs.values()) <= 1e-5:
        raise AssertionError(f"ssd layer: launches {launches}, relative L2 "
                             f"errors {errs} (bound 1e-5)")
    emit("ssd", d_model=cfg.d_model, batch=2, seq=512, chunks=2,
         rel_l2_err=errs, max_abs_err=max_err(y_k, y_p),
         state_max_abs=float(s_p.abs().max()), kernels_ms=t_k, plain_ms=t_p)


def phase_serve(cfg, params, phase="serve"):
    import torch
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ChordsEngine, ContinuousEngine, Request
    n, k, s, rtol = 50, 8, 4, 0.05
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    per_call = per_call_launches(cfg)
    out = {}

    engine = ContinuousEngine(drift, (1, 64, 16), n, k, tgrid, num_slots=s,
                              rtol=rtol, policy="fifo", use_kernel=True,
                              device="cuda")
    for i in range(8):
        engine.submit(Request(rid=i, seed=100 + i))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = launch_counts()
    st = engine.stats()
    _check_served(done, 8, n, (1, 64, 16))
    rounds = st["rounds_total"]
    want = _want(per_call, rounds)
    if c1 != want or st["kernel_path"] != "fused-accept-cuda":
        raise AssertionError(f"ContinuousEngine launches {c1} != {want} "
                             f"(kernel_path {st['kernel_path']})")
    out["continuous"] = dict(requests=8, rounds=rounds, wall_s=wall,
                             s_per_round=wall / rounds,
                             host_syncs=st["host_syncs"],
                             kernel_path=st["kernel_path"], launches=c1,
                             rounds_used=[o.rounds_used for _, o in done])

    static = ChordsEngine(drift, (64, 16), n, k, tgrid, max_batch=s,
                          rtol=rtol, use_kernel=True, device="cuda")
    static.submit(Request(rid=-1, seed=199))
    with torch.no_grad():
        static.step()  # builds the stream graph (warm-up and capture)
    for i in range(4):
        static.submit(Request(rid=i, seed=200 + i))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        done2 = static.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c2 = launch_counts()
    _check_served(done2, 4, n, (64, 16))
    rounds = static.stats[-1]["rounds"]
    # the stream graph: the condition kernel at entry and after each round
    want = _want(per_call, rounds, accept=False, loop=rounds + 1)
    if c2 != want or static.executor.kernel_path != "fused-accept-cuda":
        raise AssertionError(f"ChordsEngine launches {c2} != {want}")
    out["static"] = dict(requests=4, rounds=rounds, wall_s=wall,
                         s_per_round=wall / rounds, launches=c2,
                         program=type(static.sampler.program).__name__,
                         host_readbacks=static.sampler.host_readbacks,
                         rounds_used=[o.rounds_used for _, o in done2])
    emit(phase, arch=cfg.name, layers=cfg.num_layers, **out)
    profile_rounds(drift, tgrid, n, k, s, phase + "/profile", per_call)
    if cfg.family == "dense":
        profile_static(drift, tgrid, n, k, s)
    return {name: c1[name] + c2[name] for name in c1}


def _want(per_call, rounds, accept=True, loop=0):
    """The launch counts of ``rounds`` served rounds: the backbone's per
    call, one accept (or, for ``ChordsEngine``, one step) kernel a round,
    and ``loop`` launches of the device loop's condition kernel."""
    return {"fused_step_rectify_accept": rounds if accept else 0,
            "fused_step_rectify": 0 if accept else rounds,
            **{name: c * rounds for name, c in per_call.items()},
            "device_loop": loop}


def _serve_trace(drift, tgrid, n, k, s, overlap, policy=None, rtol=0.0,
                 trace=None, r_dev=1, eager=False):
    """One engine serving ``trace`` (requests submitted up front) or, by
    default, the SLA trace (``sched/workload.py``), up to ``r_dev`` rounds
    a step, on the CUDA graphs or (``eager``) the eager programs,
    launch counters reset just before: (results, stats, wall s, launch
    counts). The overlap engine runs with ``guard_syncs`` (a synchronizing
    CUDA call between speculating and verifying raises) except on the
    eager programs at ``r_dev`` > 1."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.sched.workload import (drive, sla_demo_trace,
                                                  sla_engine_kwargs)
    # the SLA trace's requests carry their rtol, the others the engine's
    kw = sla_engine_kwargs(n) if trace is None else {"rtol": rtol}
    # the eager multi-round loop reads its condition back every round (it
    # is the plain version of the graphs' device-side exit): unguarded
    guard = overlap and (not eager or r_dev == 1)
    engine = _engine(drift, tgrid, n, k, s, eager, policy=policy,
                     overlap=overlap, guard_syncs=guard, **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        if trace is None:
            done = drive(engine, *sla_demo_trace(n, rtol=rtol),
                         max_rounds_on_device=r_dev)
        else:
            for req in trace:
                engine.submit(req)
            done = dict(engine.run_until_drained(
                max_rounds_on_device=r_dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return done, _stats(engine), wall, launch_counts()


def _stats(engine) -> dict:
    """``engine.stats()`` and its dispatches by program kind
    (``dispatch_kinds``: round, multi, roll)."""
    m = engine.metrics
    return dict(engine.stats(), dispatch_kinds={
        kind: int(m[f"serve.dispatches.{kind}"].value)
        if f"serve.dispatches.{kind}" in m else 0
        for kind in ("round", "multi", "roll")})


def _want_sync(per_call, st):
    """The launches of a synchronous run, from the engine's own numbers:
    every round ran once on the device, and each ``multi`` evaluated the
    loop condition once at entry and once a round."""
    kinds, rounds = st["dispatch_kinds"], st["rounds_total"]
    return _want(per_call, rounds,
                 loop=kinds["multi"] + rounds - kinds["round"])


def _sync_vs_overlap(what, per_call, run):
    """``run(overlap)`` in both modes: every dispatched round (wasted ones
    included) launched the accept kernel once and the backbone's per-round
    counts, and per request the overlap engine's sample is bitwise the
    synchronous one's, with equal rounds, core and latency; the deadline,
    preemption, round and served counts are equal. Returns both modes'
    (results, stats, wall) and the summed launch counts."""
    import torch
    res, total = {}, {}
    for overlap in (False, True):
        done, st, wall, counts = run(overlap)
        rounds = st["rounds_total"] + st["speculated_rounds_wasted"]
        want = _want(per_call, rounds)
        if counts != want or st["dispatches"] != rounds:
            raise AssertionError(
                f"{what} overlap {overlap}: launches {counts} != {want} "
                f"(dispatches {st['dispatches']}, rounds {rounds})")
        total = {name: total.get(name, 0) + c for name, c in counts.items()}
        res[overlap] = (done, st, wall)
    (d_s, st_s, _), (d_o, st_o, _) = res[False], res[True]
    if sorted(d_s) != sorted(d_o):
        raise AssertionError(f"{what}: served {sorted(d_s)} vs {sorted(d_o)}")
    for rid, a in d_s.items():
        b = d_o[rid]
        if not (torch.equal(a.sample, b.sample)
                and (a.rounds_used, a.accepted_core, a.latency_rounds) ==
                (b.rounds_used, b.accepted_core, b.latency_rounds)):
            raise AssertionError(
                f"{what}: request {rid} sync ({a.rounds_used}, "
                f"{a.accepted_core}, {a.latency_rounds}) vs overlap "
                f"({b.rounds_used}, {b.accepted_core}, {b.latency_rounds}), "
                f"max err {max_err(a.sample, b.sample)}")
    for key in ("deadline_misses", "preemptions", "rounds_total", "served"):
        if st_s[key] != st_o[key]:
            raise AssertionError(f"{what}: {key} {st_s[key]} vs {st_o[key]}")
    if st_o["speculated_rounds_wasted"] > st_o["speculation_rollbacks"]:
        raise AssertionError(f"{what}: overlap stats {st_o}")
    return res, total


SPEC_KEYS = ("rounds_total", "host_syncs", "speculations",
             "speculation_confirms", "speculation_rollbacks",
             "speculated_rounds_wasted", "drain_lag_rounds", "dispatches",
             "round_gap_mean_s", "round_gap_p95_s", "deadline_misses",
             "preemptions")


def _modes_record(res, **extra):
    d_s = res[False][0]
    rec = dict(extra, bitwise=True,
               rounds_used=[d_s[r].rounds_used for r in sorted(d_s)])
    for overlap, mode in ((False, "sync"), (True, "overlap")):
        _, st, wall = res[overlap]
        rec[mode] = dict(wall_s=wall, s_per_round=wall / st["rounds_total"],
                         **{key: st[key] for key in SPEC_KEYS})
    return rec


def phase_overlap_serve(cfg, params, phase="overlap-serve"):
    """The SLA trace (4 bulk requests, 2 urgent with tight deadlines and 2
    soft ones arriving mid-run) at the launcher defaults (latent (1, 64,
    16), K=8, S=4, N=50) through the synchronous and the overlap engine,
    with FIFO and EDF-preempt, at rtol 0 and 0.05, in one process
    (:func:`_sync_vs_overlap` holds the two modes equal); at rtol 0 nothing
    rolls back, and the overlap engine reads back less often. Then a
    rollback trace: two requests on one slot at rtol 1e-9, where no two
    emissions agree, so the lane runs to the force-accept round N while the
    cold cost model predicts it done earlier, and speculative re-admissions
    of the slot roll back: at least one rollback, 2N rounds, and the same
    bitwise and launch checks (wasted rounds included). No synchronizing
    call runs between speculating and verifying in any overlap run. Last, a
    profiled window of each mode on a full grid gives its device idle
    share."""
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.serve import Request
    n, k, s = 50, 8, 4
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    per_call = per_call_launches(cfg)
    runs, total = [], {}
    for policy in ("fifo", "edf-preempt"):
        for rtol in (0.0, 0.05):
            what = f"{phase} {policy} rtol {rtol}"
            res, counts = _sync_vs_overlap(
                what, per_call, lambda overlap: _serve_trace(
                    drift, tgrid, n, k, s, overlap, policy, rtol))
            total = {name: total.get(name, 0) + c
                     for name, c in counts.items()}
            _check_served(list(res[False][0].items()), 8, n, (1, 64, 16))
            st_s, st_o = res[False][1], res[True][1]
            if (rtol == 0.0 and st_o["speculation_rollbacks"]) \
                    or st_o["host_syncs"] >= st_s["host_syncs"]:
                raise AssertionError(f"{what}: overlap stats {st_o}")
            runs.append(_modes_record(res, policy=policy, rtol=rtol))
            emit(phase + "/trace", **runs[-1])
    what = f"{phase} rollback"
    res, counts = _sync_vs_overlap(
        what, per_call, lambda overlap: _serve_trace(
            drift, tgrid, n, k, 1, overlap, rtol=1e-9,
            trace=[Request(rid=rid, seed=500 + rid) for rid in (0, 1)]))
    total = {name: total.get(name, 0) + c for name, c in counts.items()}
    _check_served(list(res[False][0].items()), 2, n, (1, 64, 16))
    st_s, st_o = res[False][1], res[True][1]
    if st_o["speculation_rollbacks"] < 1 \
            or st_s["rounds_total"] != 2 * n:
        raise AssertionError(f"{what}: rounds {st_s['rounds_total']}, "
                             f"overlap stats {st_o}")
    runs.append(_modes_record(res, policy="fifo", rtol=1e-9, slots=1))
    emit(phase + "/rollback", **runs[-1])
    emit(phase + "/no-sync", **no_sync_count(lambda: _serve_trace(
        drift, tgrid, n, k, 1, True, rtol=1e-9,
        trace=[Request(rid=rid, seed=500 + rid) for rid in (0, 1)]),
        what))
    idle = {mode: profile_rounds(drift, tgrid, n, k, s,
                                 f"{phase}/profile-{mode}", per_call,
                                 overlap=mode == "overlap", timed=10)
            for mode in ("sync", "overlap")}
    emit(phase, arch=cfg.name, layers=cfg.num_layers, runs=len(runs),
         profile=idle)
    return total


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def no_sync_count(run, what) -> dict:
    """The second count behind "no synchronizing call between speculating
    and verifying": ``run()`` (an overlap engine with ``guard_syncs``) in a
    gap-padded profiler window (:func:`profiled`); among the CUDA runtime
    calls made inside an ``overlap/no_sync`` range (the engine's speculate
    -> dispatch span, and the fast path's dispatch), none may synchronize:
    no ``SYNC_CALLS`` and no memcpy that is not ``*Async``. A call belongs
    to a range when the range encloses it in the profiler's operator tree
    (``cpu_parent``), not by time: the runtime calls' timestamps come from
    CUPTI and read up to a few hundred µs off the operators' (a ``.item()``
    made just before a range opened showed inside it by time)."""
    import torch
    prof = profiled(lambda: None, run, raw=True)
    events = prof.events()
    windows = sum(e.name == "overlap/no_sync" for e in events)
    seen, bad = {}, []
    for e in events:
        if not e.name.startswith("cuda") \
                or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        parents, p = [], e.cpu_parent
        while p is not None:
            parents.append(p.name)
            p = p.cpu_parent
        if "overlap/no_sync" not in parents:
            continue
        seen[e.name] = seen.get(e.name, 0) + 1
        if e.name in SYNC_CALLS or (e.name.startswith("cudaMemcpy")
                                    and "Async" not in e.name):
            bad.append({"name": e.name, "parents": parents})
    rec = {"windows": windows, "runtime_events": sum(seen.values()),
           "by_name": seen, "sync_calls": len(bad)}
    if bad or not windows or not seen:
        raise AssertionError(f"{what}: synchronizing calls inside the "
                             f"no-sync ranges {bad}; {rec}")
    return rec


# kernel-name substrings of the port's kernels in profiler keys
PORT_KERNEL_TAGS = ("step_rectify_kernel", "step_rectify_accept_kernel",
                    "rmsnorm_rows_kernel", "rmsnorm_sweep_kernel",
                    "flash_fwd_kernel", "flash_fwd_mma_kernel",
                    "ssd_chunk_kernel")


def _device_events(prof):
    import torch
    # kernels are CUDA-typed events; the engine's "dispatch/round" range and
    # the profiler's own "ProfilerStep#" range also show on the device
    # timeline and would count every kernel twice; the window's primer
    # (:func:`profiled`) is not the body's
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(("dispatch/", "ProfilerStep"))
            and PRIME_TAG not in e.key]


# the kernel behind each wrapper on the bf16 serving paths
SERVE_TAGS = {"rmsnorm": "rmsnorm_rows_kernel",
              "flash_attention": "flash_fwd_mma_kernel",
              "ssd_chunk": "ssd_chunk_kernel"}


def _port_kernels(events, rounds):
    """Launches per round and device ms per launch of each tag, summed
    over the profiler keys (template instances) that carry it."""
    sums = {}
    for e in events:
        for tag in PORT_KERNEL_TAGS:
            if tag in e.key:
                n, us = sums.get(tag, (0, 0.0))
                sums[tag] = (n + e.count, us + e.self_device_time_total)
    return {tag: {"launches_per_round": n / rounds,
                  "device_ms_per_launch": us / 1e3 / n}
            for tag, (n, us) in sums.items()}


def _check_profiled_launches(ours, per_round):
    """Each backbone kernel shows under its own name with the launches the
    counters predict: a kernel renamed without PORT_KERNEL_TAGS would
    otherwise drop out of the profile unnoticed."""
    for name, count in per_round.items():
        got = ours.get(SERVE_TAGS[name], {}).get("launches_per_round")
        if count and got != count:
            raise AssertionError(f"profile: {SERVE_TAGS[name]} launched "
                                 f"{got} times a round, want {count}")


def _engine(drift, tgrid, n, k, s, eager=False, **kw):
    """A ``ContinuousEngine`` at the launcher's latent on its own executor
    (``eager``: the eager programs)."""
    from repro_torch.serve import ContinuousEngine
    from repro_torch.serve.executor import RoundExecutor
    ex = RoundExecutor(drift, tgrid, n, use_kernel=True, eager=eager)
    return ContinuousEngine(drift, (1, 64, 16), n, k, tgrid, num_slots=s,
                            executor=ex, device="cuda", **kw)


def profile_rounds(drift, tgrid, n, k, s, phase, per_call,
                   rounds: int = 3, overlap: bool = False,
                   timed: int = 0, eager: bool = False, r_dev: int = 1,
                   accept_path: bool = True):
    """Where a serving round's time goes, on a full grid after one warm
    step (rtol 0: no lane drains), in the synchronous loop or, with
    ``overlap``, the overlap loop (whose steps there all take the fast
    path), each step up to ``r_dev`` rounds, on the CUDA graphs (default)
    or the eager programs (``eager``): ``timed`` steps (default
    ``rounds``) timed without the profiler (wall per round, the host's
    time per round before the final synchronize: in the overlap loop its
    enqueue alone; and the device's span per round, CUDA events around
    each step, which counts the gaps inside a graph as busy), then, at
    ``r_dev`` 1, ``rounds`` steps under ``torch.profiler``
    after one warm-up step (device time by kernel; each backbone kernel's
    launches per round must equal ``per_call``, one drift call a round; a
    window whose records fall short of the kernels' own device counts is
    opened again, up to ``ONE_KERNEL_WINDOWS``, as in
    :func:`check_one_kernel`; ``accept_path``: the accept call launches one
    kernel). The idle share is 1 - device time / unprofiled wall time.

    At ``r_dev`` > 1 no window is profiled: a step is up to 8 rounds
    (~16 000 kernels DiT, ~34 000 hybrid), and the profiler's records of
    such windows were not exact (a loop graph's dropped, up to all of a
    window's; 8 replays of the hybrid round once read 82.25 rmsnorm
    launches a round). The device time is then elapsed time, gaps between
    kernels counted busy: a synchronous step on the graphs is one
    ``multi`` loop graph, timed by the loop's own clock
    (``device_loop.clock``: ``%globaltimer`` read by the condition kernel
    after each round; every timed step must be a ``multi``, and the
    device's loop-round word must equal the engine's rounds); otherwise
    the CUDA-event span of each step."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.device_loop.kernel import clock
    from repro_torch.serve import Request
    engine = _engine(drift, tgrid, n, k, s, eager, rtol=0.0,
                     overlap=overlap)
    for i in range(s):
        engine.submit(Request(rid=i, seed=300 + i))
    timed = timed or rounds
    loop_graph = r_dev > 1 and not (overlap or eager)
    profile = r_dev == 1
    with torch.no_grad():
        engine.step(r_dev)
        torch.cuda.synchronize()
        r0 = engine.round_count
        if loop_graph:
            ctrl = engine._prog.graphs.ctrl  # [2]: loop rounds run so far
            ns0, multis0 = clock()[1], _stats(engine)["dispatch_kinds"]
            lr0 = int(ctrl[2])
        spans = []
        t0 = time.perf_counter()
        for _ in range(timed):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            engine.step(r_dev)
            b.record()
            spans.append((a, b))
        host = time.perf_counter() - t0  # before the device drains
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed_rounds = engine.round_count - r0
        span_ms = sum(a.elapsed_time(b) for a, b in spans) / timed_rounds
        if loop_graph:
            loop_ms = (clock()[1] - ns0) / 1e6 / timed_rounds
            kinds = _stats(engine)["dispatch_kinds"]
            loop_rounds = int(ctrl[2]) - lr0
            if kinds["multi"] - multis0["multi"] != timed \
                    or kinds["round"] != multis0["round"] \
                    or loop_rounds != timed_rounds:
                raise AssertionError(f"{phase}: steps {multis0} -> {kinds}, "
                                     f"want {timed} multi; the device "
                                     f"counted {loop_rounds} loop rounds, "
                                     f"the engine {timed_rounds}")
        span = []

        def body():
            span[:] = [engine.round_count]
            for _ in range(rounds):
                engine.step(r_dev)
            span.append(engine.round_count)

        events = []
        for _ in range(ONE_KERNEL_WINDOWS if profile else 0):
            # the kernels' own device counts over the window (warm-up step
            # and body): a window whose profiler records fall short of them
            # lost records in the profiler and is opened again
            reset_launch_counts()
            w0 = engine.round_count
            events = profiled(lambda: engine.step(r_dev), body)
            dev, dev_rounds = launch_counts(), engine.round_count - w0
            ours = _port_kernels(events, span[1] - span[0])
            short = {name: ours.get(SERVE_TAGS[name], {}).get(
                "launches_per_round", 0) for name, c in per_call.items()
                if c and ours.get(SERVE_TAGS[name], {}).get(
                    "launches_per_round") != c}
            if not short or not all(
                    dev[name] == c * dev_rounds and short.get(name, 0) < c
                    for name, c in per_call.items() if c):
                break
            emit("profiler-loss", what=phase, per_round_recorded=short,
                 per_round_on_device={name: dev[name] / dev_rounds
                                      for name in short})
    if engine.stats()["served"] or timed_rounds < 1:
        raise AssertionError(f"{phase}: a lane finished inside the steady "
                             f"window ({engine.round_count} rounds)")
    wall, host = wall / timed_rounds, host / timed_rounds
    rec = dict(timed_rounds=timed_rounds, overlap=overlap, r_dev=r_dev,
               programs=engine.executor.programs,
               wall_ms_per_round=wall * 1e3, host_ms_per_round=host * 1e3,
               span_ms_per_round=span_ms,
               span_idle_share=max(0.0, 1.0 - span_ms / (wall * 1e3)),
               rounds=None, device_ms_per_round=None,
               device_idle_share=None, kernels_per_round=None,
               host_syncs=engine.host_syncs, device_ms_from="profiler")
    if not profile:
        ms = loop_ms if loop_graph else span_ms
        rec.update(rounds=timed_rounds, device_ms_per_round=ms,
                   device_idle_share=max(0.0, 1.0 - ms / (wall * 1e3)),
                   device_ms_from="loop clock" if loop_graph
                   else "event span")
        emit(phase, **rec)
        return rec
    prof_rounds = span[1] - span[0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / prof_rounds
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    ours = _port_kernels(events, prof_rounds)
    rec.update(rounds=prof_rounds, device_ms_per_round=busy,
               device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
               kernels_per_round=sum(
                   e.count for e in events
                   if not e.key.startswith(("Memcpy", "Memset")))
               / prof_rounds)
    emit(phase, **rec, port_kernels=ours,
         accept_path=_accept_path_kernels(s * k, 64 * 16, s)
         if accept_path else None,
         top=[{"name": e.key[:80], "calls_per_round": e.count / prof_rounds,
               "ms_per_round": e.self_device_time_total / 1e3 / prof_rounds}
              for e in top])
    _check_profiled_launches(ours, per_call)
    got = ours.get("step_rectify_accept_kernel", {}).get("launches_per_round")
    if got != 1:
        raise AssertionError(f"profile: step_rectify_accept_kernel launched "
                             f"{got} times a round, want 1")
    return rec


# CUgraphNodeType (driver API)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record", 10: "mem_alloc",
              11: "mem_free", 13: "conditional"}


def graph_nodes(raw: int) -> dict:
    """The nodes of a CUDA graph (a ``cudaGraph_t`` as an int) by type, and
    its kernel nodes by the port's kernel tags (driver API: the node's
    function and ``cuFuncGetName``)."""
    import ctypes
    from ctypes import byref, c_char_p, c_int, c_size_t, c_uint, c_void_p
    cu = ctypes.CDLL("libcuda.so.1")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", c_void_p), ("grid", c_uint * 3),
                    ("block", c_uint * 3), ("smem", c_uint),
                    ("params", c_void_p), ("extra", c_void_p),
                    ("kern", c_void_p), ("ctx", c_void_p)]

    def check(what, err):
        if err:
            raise AssertionError(f"{what} failed: CUresult {err}")

    graph, n = c_void_p(raw), c_size_t(0)
    check("cuGraphGetNodes", cu.cuGraphGetNodes(graph, None, byref(n)))
    nodes = (c_void_p * n.value)()
    check("cuGraphGetNodes", cu.cuGraphGetNodes(graph, nodes, byref(n)))
    types, tags = {}, {}
    for node in nodes:
        kind = c_int(-1)
        check("cuGraphNodeGetType",
              cu.cuGraphNodeGetType(c_void_p(node), byref(kind)))
        name = NODE_TYPES.get(kind.value, str(kind.value))
        types[name] = types.get(name, 0) + 1
        if kind.value != 0:
            continue
        p = KernelNodeParams()
        check("cuGraphKernelNodeGetParams",
              cu.cuGraphKernelNodeGetParams_v2(c_void_p(node), byref(p)))
        fname = c_char_p()
        if p.func:
            check("cuFuncGetName", cu.cuFuncGetName(byref(fname),
                                                    c_void_p(p.func)))
        else:
            check("cuKernelGetName", cu.cuKernelGetName(byref(fname),
                                                        c_void_p(p.kern)))
        for tag in PORT_KERNEL_TAGS:
            if tag in fname.value.decode():
                tags[tag] = tags.get(tag, 0) + 1
    return {"types": types, "port_kernels": tags}


def _round_graph(drift, tgrid, n, k, s, per_call, phase):
    """The round graph's nodes against the eager round's launches: its
    kernel nodes equal the kernels a profiled eager round launches and the
    kernel nodes of a graph captured from one eager round
    (:func:`graph_kernel_nodes`); the port's kernels among them are the
    backbone's per call and one accept kernel, and one replay runs exactly
    those (the kernels' own counts)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request
    engine = _engine(drift, tgrid, n, k, s, rtol=0.0)
    grid = engine._prog.graphs
    nodes = graph_nodes(grid.graph.raw_cuda_graph())
    reset_launch_counts()
    with torch.no_grad():
        grid.round(grid.state)  # an empty grid: the identity
    replay = launch_counts()
    eager = _engine(drift, tgrid, n, k, s, True, rtol=0.0)
    for i in range(s):
        eager.submit(Request(rid=i, seed=300 + i))
    with torch.no_grad():
        eager.step()
        prog, st = eager._prog, eager.state
        events = profiled(lambda: prog.round(st), lambda: prog.round(st))
        eager_nodes = graph_kernel_nodes(lambda: prog.round(st))
    eager_kernels = sum(e.count for e in events
                        if not e.key.startswith(("Memcpy", "Memset")))
    want_tags = {SERVE_TAGS[name]: c for name, c in per_call.items() if c}
    want_tags["step_rectify_accept_kernel"] = 1
    rec = dict(kernel_nodes=nodes["types"].get("kernel", 0),
               node_types=nodes["types"],
               port_kernel_nodes=nodes["port_kernels"],
               eager_round_profiled_kernels=eager_kernels,
               eager_round_profiled_copies=sum(
                   e.count for e in events
                   if e.key.startswith(("Memcpy", "Memset"))),
               eager_round_graph_kernel_nodes=eager_nodes,
               launches_per_replay=replay,
               graph_build_s=grid.build_s)
    emit(phase + "/graph", card=CARD[0], **rec)
    if not (rec["kernel_nodes"] == eager_kernels == eager_nodes) \
            or nodes["port_kernels"] != want_tags \
            or replay != _want(per_call, 1):
        raise AssertionError(f"{phase}: round graph {rec}, want the port's "
                             f"kernels {want_tags}")


def phase_device_loop(cfg, params, phase="device-loop"):
    """The multi-round device loop at the launcher defaults (latent (1, 64,
    16), K=8, S=4, N=50): see the module docstring, phases 11 and 12."""
    import torch
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request
    n, k, s, rtol = 50, 8, 4, 0.05
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    per_call = per_call_launches(cfg)
    total: dict = {}

    def add(counts):
        for name, c in counts.items():
            total[name] = total.get(name, 0) + c

    # -- the launcher defaults through the synchronous loop ----------------
    runs, recs = {}, {}
    for label, eager, r_dev in (("eager-R1", True, 1),
                                ("graph-R1", False, 1),
                                ("graph-R8", False, 8)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = _engine(drift, tgrid, n, k, s, eager, rtol=rtol,
                         policy="fifo")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for i in range(8):
            engine.submit(Request(rid=i, seed=100 + i))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            done = dict(engine.run_until_drained(max_rounds_on_device=r_dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, st = launch_counts(), _stats(engine)
        _check_served(list(done.items()), 8, n, (1, 64, 16))
        rounds = st["rounds_total"]
        want = _want_sync(per_call, st)
        if counts != want or (r_dev > 1) != (st["dispatch_kinds"]["multi"]
                                             > 0):
            raise AssertionError(f"{phase} {label}: launches {counts} != "
                                 f"{want} (dispatches "
                                 f"{st['dispatch_kinds']})")
        add(counts)
        grid = engine._prog.graphs
        runs[label] = (done, st)
        recs[label] = dict(
            programs=st["programs"], r_dev=r_dev, rounds=rounds,
            host_syncs=st["host_syncs"], dispatches=st["dispatch_kinds"],
            wall_s=wall, s_per_round=wall / rounds,
            engine_build_s=build_s,
            graph_build_s=grid.build_s if grid is not None else None,
            peak_memory_gb_after_build=peak / 1e9, launches=counts)
        del engine, grid
    base = runs["eager-R1"]
    for label, (done, st) in runs.items():
        for rid, a in base[0].items():
            b = done[rid]
            if not (torch.equal(a.sample, b.sample)
                    and (a.rounds_used, a.accepted_core, a.latency_rounds)
                    == (b.rounds_used, b.accepted_core, b.latency_rounds)):
                raise AssertionError(
                    f"{phase} {label}: request {rid} differs from eager R=1 "
                    f"(max err {max_err(a.sample, b.sample)})")
        if st["rounds_total"] != base[1]["rounds_total"]:
            raise AssertionError(f"{phase} {label}: rounds "
                                 f"{st['rounds_total']} vs "
                                 f"{base[1]['rounds_total']}")
    st8 = runs["graph-R8"][1]
    if not 2 * st8["host_syncs"] <= st8["rounds_total"]:
        raise AssertionError(f"{phase}: R=8 host syncs {st8['host_syncs']} "
                             f"for {st8['rounds_total']} rounds")
    emit(phase + "/sync", card=CARD[0], bitwise=True, runs=recs)

    # -- the SLA and rollback traces through the overlap loop --------------
    # R=8 on the graphs against R=1 on the graphs and R=8 on the eager
    # programs. The SLA trace's arrivals can fall inside a roll, and the
    # engine (as the JAX package's) submits them at the next step, so its
    # schedule at R=8 is held to eager R=8; the rollback trace submits
    # everything at once, so there R=1's schedule must hold too.
    traces = {}
    for what, slots, policy, trtol, upfront in (
            ("sla edf-preempt rtol 0", s, "edf-preempt", 0.0, False),
            ("rollback", 1, "fifo", 1e-9, True)):
        res = {}
        for label, eager, r_dev in (("graph-R1", False, 1),
                                    ("graph-R8", False, 8),
                                    ("eager-R8", True, 8)):
            reqs = ([Request(rid=rid, seed=500 + rid) for rid in (0, 1)]
                    if upfront else None)
            done, st, wall, counts = _serve_trace(
                drift, tgrid, n, k, slots, True, policy, trtol, reqs, r_dev,
                eager=eager)
            acc = counts["fused_step_rectify_accept"]
            kinds = st["dispatch_kinds"]
            dispatched = st["rounds_total"] + st["speculated_rounds_wasted"]
            if eager:
                # the eager roll stops when no lane is live (a lane accepted
                # before its predicted round): at most the rounds the host
                # dispatched, the condition once at entry and once a round
                ok = 0 < acc <= dispatched
                loop = kinds["roll"] + acc - kinds["round"]
            else:
                # the graph roll replays the round k times
                ok, loop = acc == dispatched, 0
            if not ok or kinds["multi"] or (r_dev == 1) != (
                    kinds["roll"] == 0) or counts != _want(per_call, acc,
                                                           loop=loop):
                raise AssertionError(f"{phase} {what} {label}: launches "
                                     f"{counts}, {dispatched} rounds, "
                                     f"dispatches {kinds}")
            add(counts)
            res[label] = (done, st, wall)
        d1 = res["graph-R1"][0]
        for label, (done, st, _) in res.items():
            for rid, a in d1.items():
                b = done[rid]
                if not (torch.equal(a.sample, b.sample)
                        and (a.rounds_used, a.accepted_core)
                        == (b.rounds_used, b.accepted_core)):
                    raise AssertionError(
                        f"{phase} {what}: request {rid} {label} vs graph "
                        f"R=1 (max err {max_err(a.sample, b.sample)})")
        same = [("graph-R8", "eager-R8")] + (
            [("graph-R8", "graph-R1")] if upfront else [])
        for a, b in same:
            sa, sb = res[a][1], res[b][1]
            for key in SPEC_KEYS[:8] + ("served",):
                if key != "dispatches" or b != "graph-R1":
                    if sa[key] != sb[key]:
                        raise AssertionError(f"{phase} {what}: {key} "
                                             f"{sa[key]} {a}, {sb[key]} {b}")
        traces[what] = {label: dict(
            programs=st["programs"], wall_s=w,
            s_per_round=w / st["rounds_total"],
            **{key: st[key] for key in SPEC_KEYS})
            for label, (_, st, w) in res.items()}
    traces["no_sync_R8"] = no_sync_count(lambda: _serve_trace(
        drift, tgrid, n, k, s, True, "edf-preempt", 0.0, None, 8),
        f"{phase} no-sync R=8")
    emit(phase + "/overlap", card=CARD[0], bitwise=True, traces=traces)

    _round_graph(drift, tgrid, n, k, s, per_call, phase)

    # -- a steady window of each program kind, in each loop ----------------
    steady = {}
    for overlap in (False, True):
        for label, eager, r_dev, timed, rounds in (
                ("eager-R1", True, 1, 10, 3), ("graph-R1", False, 1, 10, 3),
                ("graph-R8", False, 8, 5, 1)):
            loop = "overlap" if overlap else "sync"
            steady[f"{loop}/{label}"] = profile_rounds(
                drift, tgrid, n, k, s, f"{phase}/steady-{loop}-{label}",
                per_call, rounds=rounds, overlap=overlap, timed=timed,
                eager=eager, r_dev=r_dev, accept_path=False)
    emit(phase, arch=cfg.name, layers=cfg.num_layers, card=CARD[0],
         steady={key: {f: v[f] for f in (
             "wall_ms_per_round", "host_ms_per_round", "span_ms_per_round",
             "span_idle_share", "device_ms_per_round", "device_idle_share",
             "kernels_per_round", "rounds", "timed_rounds", "host_syncs",
             "device_ms_from")}
             for key, v in steady.items()})
    return total


# -- elastic resize and heterogeneous lanes -----------------------------------

BF16_RTOL, BF16_ATOL = 8e-2, 5e-2  # src/repro/kernels/README.md, bf16


def matmul_row_independence(cfg, params, x, t, parts=(2, 4)) -> dict:
    """Every matrix product of one drift call on ``x`` (a full grid),
    recomputed on the first 1/p of its rows (the rows of a grid p times
    smaller) and compared with those rows of the full product, in context
    (``TorchFunctionMode`` sees each ``torch.einsum`` and ``@`` with its
    operands). Returns {"op equation shapes, 1/p": max abs diff}."""
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.diffusion import denoise
    probed = {torch.einsum: "einsum", torch.matmul: "matmul",
              torch.Tensor.__matmul__: "matmul",
              torch.Tensor.matmul: "matmul", torch.mm: "mm"}
    from repro_torch.diffusion import wrapper as W
    found = {}
    inside = [False]  # in row_product: probed as one function below

    class Probe(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func not in probed or inside[0]:
                return out
            idx = [i for i, a in enumerate(args)
                   if isinstance(a, torch.Tensor)]
            a = args[idx[0]]
            eq = args[0] if isinstance(args[0], str) else ""
            shapes = "x".join(str(list(args[i].shape)) for i in idx)
            # the operands that carry the batch: by subscript (the output's
            # leading one) for einsum; the left one, and a batched right
            # one, for @
            if eq:
                ins, outs = eq.replace(" ", "").split("->")
                rows = [i for i, sub in zip(idx, ins.split(","))
                        if sub[:1] == outs[:1]]
            else:
                rows = [idx[0]] + [i for i in idx[1:] if args[i].ndim >= 3
                                   and args[i].shape[0] == a.shape[0]]
            a = args[rows[0]]
            for p in parts:
                if a.shape[0] % p or out.shape[0] != a.shape[0]:
                    continue
                sub = list(args)
                for i in rows:
                    sub[i] = args[i][:a.shape[0] // p]
                alone = func(*sub, **kwargs)  # the mode is off in here
                key = f"{probed[func]} {eq} {shapes} {a.dtype}, 1/{p}"
                found[key] = max(found.get(key, 0.0),
                                 max_err(alone, out[:alone.shape[0]]))
            return out

    row_product = W.row_product

    def probe_row_product(x, w, piece_rows):
        """The drift's f32 products in fixed pieces of rows (the
        out-projection, the time MLP) as the function the drift calls: the
        first 1/p of the rows alone against the same rows of the whole
        call."""
        inside[0] = True
        try:
            out = row_product(x, w, piece_rows)
            for p in parts:
                if x.ndim < 2 or x.shape[0] % p:
                    continue
                alone = row_product(x[:x.shape[0] // p], w, piece_rows)
                key = (f"row_product {list(x.shape)}x{list(w.shape)} "
                       f"pieces of {piece_rows} {x.dtype}, 1/{p}")
                found[key] = max(found.get(key, 0.0),
                                 max_err(alone, out[:alone.shape[0]]))
        finally:
            inside[0] = False
        return out

    W.row_product = probe_row_product
    try:
        with torch.no_grad(), Probe():
            denoise(params, cfg.replace(use_kernels=True), x, t)
    finally:
        W.row_product = row_product
    if sum(key.startswith("row_product") for key in found) < 3 * len(parts):
        raise AssertionError(f"row probe: the pieced products were not all "
                             f"probed: {sorted(found)}")
    return found


def row_independence(cfg, params, k: int = 8) -> dict:
    """Whether the drift's ops give a row the same bits whatever the batch
    around it: the first slot's rows ([k, 64, 16]) computed alone (one
    slot, S=1) against inside a grid of four slots (S=4): the rmsnorm and
    flash kernels at the served shapes, the whole drift, and every matrix
    product of the drift in context (:func:`matmul_row_independence`:
    those that differ are listed; the f32 products the drift computes in
    fixed pieces of rows, the out-projection and the time MLP, as the
    function it calls, ``wrapper.row_product``), on a grid of four slots
    and of two. The port's kernels are row independent by construction; a
    GEMM library may pick another algorithm or split for another row count,
    which the fixed pieces undo. Returns each op's max abs difference."""
    import torch
    from repro_torch.diffusion import denoise
    from repro_torch.kernels.flash_attention.ops import attend
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    gen = torch.Generator(device="cuda").manual_seed(7)
    d, rows = cfg.d_model, k * 64
    bf = torch.bfloat16
    h = torch.randn(4 * rows, d, generator=gen, device="cuda").to(bf)
    g = torch.ones(d, device="cuda", dtype=bf)
    q = torch.randn(4 * k, 64, cfg.num_heads, d // cfg.num_heads,
                    generator=gen, device="cuda").to(bf)
    x = torch.randn(4 * k, 64, 16, generator=gen, device="cuda")
    t = torch.rand(4 * k, generator=gen, device="cuda")
    kcfg = cfg.replace(use_kernels=True)
    out = {}
    with torch.no_grad():
        out["rmsnorm_kernel"] = max_err(
            rmsnorm(h[:rows], g, 1e-6, use_kernel=True),
            rmsnorm(h, g, 1e-6, use_kernel=True)[:rows])
        out["flash_kernel"] = max_err(
            attend(q[:k], q[:k], q[:k], causal=False, use_kernel=True),
            attend(q, q, q, causal=False, use_kernel=True)[:k])
        alone = denoise(params, kcfg, x[:k], t[:k])
        out["drift"] = max_err(alone, denoise(params, kcfg, x, t)[:k])
        out["drift_2_slots"] = max_err(
            alone, denoise(params, kcfg, x[:2 * k], t[:2 * k])[:k])
    products = matmul_row_independence(cfg, params, x, t)
    products.update({f"{key} (2-slot grid)": d for key, d in
                     matmul_row_independence(cfg, params, x[:2 * k],
                                             t[:2 * k], parts=(2,)).items()})
    out["products_probed"] = len(products)
    out["products_not_row_independent"] = {
        key: d for key, d in products.items() if d != 0.0}
    return out


def _check_migration(executor, checks):
    """Wrap ``executor.migrate`` so every migration of the run is held to
    a row copy: each filled destination lane's tensors equal its source
    lane's bitwise (read back after the gather, outside the timed run's
    no-sync spans: a resize runs at the top of a step)."""
    import torch
    from repro_torch.serve.executor import state_tensors
    orig = executor.migrate

    def migrate(src_spec, dst_spec):
        run = orig(src_spec, dst_spec)

        def go(dst, src, mask, idx):
            before = [t.clone() for t in state_tensors(src)]
            out = run(dst, src, mask, idx)
            m, i = mask.cpu().tolist(), idx.cpu().tolist()
            for o, s_ in zip(state_tensors(out), before):
                for lane, on in enumerate(m):
                    if on and not torch.equal(o[lane], s_[i[lane]]):
                        raise AssertionError(
                            f"migration {src_spec.num_slots} -> "
                            f"{dst_spec.num_slots}: lane {lane} differs "
                            f"from source lane {i[lane]}")
            checks.append({"src": src_spec.num_slots,
                           "dst": dst_spec.num_slots, "lanes": sum(m),
                           "tensors": len(before), "bitwise": True})
            return out

        return go

    executor.migrate = migrate


def _bursty_run(drift, tgrid, n, k, r_dev=1, overlap=False, tracer=None,
                migrate_checks=None, **kw):
    """``bursty_trace(n, burst=4, quiet=2)`` (rtol 0: every lane runs n
    rounds) through a fresh engine; (results, stats, wall s, launch counts,
    engine). ``drive`` jumps the round clock over idle stretches,
    so the rounds the device ran are the accept kernel's launches."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve.sched.workload import bursty_trace, drive
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = _engine(drift, tgrid, n, k, kw.pop("num_slots", 4), rtol=0.0,
                     overlap=overlap, tracer=tracer, guard_syncs=overlap,
                     **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if migrate_checks is not None:
        _check_migration(engine.executor, migrate_checks)
    # the grid size of every round a step ran, and the requests live in it
    sched, step = {}, engine.step

    def live():
        return {it.payload.rid for it in engine._slot_item if it is not None}

    def logged(max_rounds_on_device=1):
        r0, before = engine.round_count, live()
        out = step(max_rounds_on_device=max_rounds_on_device)
        rids = frozenset(before | live() | {rid for rid, _ in out})
        for r in range(r0, engine.round_count):
            sched[r] = (engine.s, rids)
        return out

    engine.step = logged
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        done = drive(engine, *bursty_trace(n, burst=4, quiet=2),
                     max_rounds_on_device=r_dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return done, dict(_stats(engine), build_s=build_s, sched=sched), wall, \
        launch_counts(), engine


def _check_bursty_launches(what, per_call, st, counts):
    """Every round the device ran launched one accept kernel and the
    backbone's per-call counts; a step is one round, or one ``multi`` (the
    loop's condition once at entry and once a round). The device ran as
    many rounds as the accept kernel counted: one a ``round`` dispatch,
    and the rest inside ``multi`` programs."""
    kinds, acc = st["dispatch_kinds"], counts["fused_step_rectify_accept"]
    loop = kinds["multi"] + acc - kinds["round"]
    if kinds["roll"] or acc < 1 or (not kinds["multi"]
                                    and acc != st["dispatches"]) \
            or counts != _want(per_call, acc, loop=loop):
        raise AssertionError(f"{what}: launches {counts}, {acc} rounds, "
                             f"dispatches {kinds}")


def _other_s(sched_a, sched_b) -> set:
    """The requests that ran some round at another grid size in one run
    than in the other (or in a round only one run dispatched)."""
    rids = set()
    for r in set(sched_a) | set(sched_b):
        a, b = sched_a.get(r, (None, frozenset())), \
            sched_b.get(r, (None, frozenset()))
        if a[0] != b[0]:
            rids |= a[1] | b[1]
    return rids


def _compare_samples(what, a_out, b_out, exempt=()) -> dict:
    """Per request: rounds used and accepted core equal (rtol 0: fixed by
    the schedule); samples bitwise, except the ``exempt`` requests (some
    round at another grid size, on a card whose drift is not row
    independent across grid sizes), which are held to the bf16 backbone
    tolerance. Returns the largest gaps."""
    import torch
    if sorted(a_out) != sorted(b_out):
        raise AssertionError(f"{what}: served {sorted(a_out)} vs "
                             f"{sorted(b_out)}")
    gap, rel, same = 0.0, 0.0, 0
    for rid, a in a_out.items():
        b = b_out[rid]
        if (a.rounds_used, a.accepted_core) != (b.rounds_used,
                                                b.accepted_core):
            raise AssertionError(f"{what}: request {rid} rounds/core "
                                 f"({a.rounds_used}, {a.accepted_core}) vs "
                                 f"({b.rounds_used}, {b.accepted_core})")
        if torch.equal(a.sample, b.sample):
            same += 1
            continue
        if rid not in exempt:
            raise AssertionError(f"{what}: request {rid} not bitwise (max "
                                 f"err {max_err(a.sample, b.sample)})")
        torch.testing.assert_close(a.sample, b.sample, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        gap = max(gap, max_err(a.sample, b.sample))
        rel = max(rel, rel_l2(a.sample, b.sample))
    return {"bitwise_requests": same, "requests": len(a_out),
            "other_s_requests": sorted(exempt), "max_abs_gap": gap,
            "max_rel_l2_gap": rel}


def phase_elastic_serve(cfg, params, phase="elastic-serve"):
    """Elastic capacity on the graphs at the launcher's latent (1, 64, 16),
    K=8, N=50: ``bursty_trace(50, burst=4, quiet=2)`` with min 1 / max 4
    slots, hysteresis 4, rtol 0, synchronous at R=1 (every migration held
    to a row copy) and R=8, then the overlap loop at R=1 (traced, its trace
    checked by ``repro_torch.obs.check``); against it fixed S=4 and pinned
    min = max = 4 (bitwise fixed S=4, equal stats). Each request's rounds
    and core equal fixed S=4's; samples bitwise where the drift's ops are
    row independent across the buckets' row counts (``row_independence``),
    else within the bf16 backbone tolerance, the gap printed. Then each
    bucket's capture time, the ladder's memory, and s a round and device
    idle share at S = 1, 2, 4 (a profiled window of a full grid)."""
    import tempfile

    import torch
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.obs import Tracer
    from repro_torch.obs.check import check, summarize
    n, k = 50, 8
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    per_call = per_call_launches(cfg)
    total: dict = {}

    rows = row_independence(cfg, params, k)
    cross_bitwise = all(rows[op] == 0.0 for op in (
        "rmsnorm_kernel", "flash_kernel", "drift", "drift_2_slots")) \
        and not rows["products_not_row_independent"]
    emit(phase + "/rows", card=CARD[0], max_abs_diff_alone_vs_in_grid=rows,
         row_independent=cross_bitwise)

    runs, migrations = {}, []
    elastic = dict(num_slots=1, min_slots=1, max_slots=4,
                   resize_hysteresis=4)
    for label, r_dev, overlap, kw in (
            ("fixed-S4", 1, False, {"num_slots": 4}),
            ("pinned-4-4", 1, False, {"num_slots": 4, "min_slots": 4,
                                      "max_slots": 4}),
            ("elastic-sync-R1", 1, False, elastic),
            ("elastic-sync-R8", 8, False, elastic),
            ("elastic-overlap-R1", 1, True, elastic)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        res0 = torch.cuda.memory_reserved()
        tracer = Tracer() if overlap else None
        done, st, wall, counts, engine = _bursty_run(
            drift, tgrid, n, k, r_dev, overlap, tracer,
            migrations if label == "elastic-sync-R1" else None, **dict(kw))
        _check_served(list(done.items()), 10, n, (1, 64, 16))
        _check_bursty_launches(f"{phase} {label}", per_call, st, counts)
        total = {name: total.get(name, 0) + c for name, c in counts.items()}
        rec = dict(r_dev=r_dev, overlap=overlap, wall_s=wall,
                   device_rounds=counts["fused_step_rectify_accept"],
                   s_per_device_round=wall
                   / max(1, counts["fused_step_rectify_accept"]),
                   engine_build_s=st["build_s"],
                   **{key: st[key] for key in (
                       "rounds_total", "host_syncs", "dispatches",
                       "resizes", "grows", "shrinks", "resize_vetoes",
                       "migrations", "buckets_visited", "retraces",
                       "migration_traces", "wasted_slot_rounds",
                       "latency_rounds_p95", "speculation_rollbacks",
                       "programs")})
        if engine.min_slots != engine.max_slots:
            rec["grid_build_s"] = {b: p.graphs and p.graphs.build_s
                                   for b, p in engine._progs.items()}
            # allocated: live tensors (state buffers, the graphs' outputs);
            # reserved: the allocator's blocks, the graphs' pools included
            rec["ladder_memory_gb"] = (torch.cuda.memory_allocated()
                                       - mem0) / 1e9
            rec["ladder_reserved_gb"] = (torch.cuda.memory_reserved()
                                         - res0) / 1e9
        if tracer is not None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "elastic_trace.json")
                doc = engine.write_trace(path, meta={"phase": phase})
                ok, lines = check(doc)
            names = [e["name"] for e in doc["traceEvents"]]
            trace = {name: names.count(name) for name in (
                "resize/grow", "resize/shrink", "migrate/lanes",
                "dispatch/migrate", "spec/rollback", "request/compute")}
            rec["trace"] = dict(events=doc["otherData"]["events"],
                                dropped=doc["otherData"]["dropped"],
                                counts=trace, check=lines,
                                summary=summarize(doc)[:6])
            if not ok or not trace["migrate/lanes"] \
                    or not (trace["resize/grow"] + trace["resize/shrink"]):
                raise AssertionError(f"{phase}: trace check {ok} {lines}, "
                                     f"events {trace}")
        runs[label] = (done, st)
        emit(phase + "/run", card=CARD[0], run=label, **rec)
        del engine
        torch.cuda.empty_cache()

    fixed_out, fixed_st = runs["fixed-S4"]
    pin_out, pin_st = runs["pinned-4-4"]
    _compare_samples(f"{phase} pinned vs fixed", fixed_out, pin_out)
    for key in ("rounds_total", "host_syncs", "dispatches",
                "wasted_slot_rounds", "latency_rounds_p95", "resizes",
                "migrations"):
        if fixed_st[key] != pin_st[key]:
            raise AssertionError(f"{phase} pinned vs fixed: {key} "
                                 f"{pin_st[key]} vs {fixed_st[key]}")
    gaps = {}
    for label in ("elastic-sync-R1", "elastic-sync-R8",
                  "elastic-overlap-R1"):
        out, st = runs[label]
        if not (st["migrations"] > 0 and st["resizes"] > 0
                and st["retraces"] <= len(st["buckets_visited"])
                and st["wasted_slot_rounds"]
                < fixed_st["wasted_slot_rounds"]):
            raise AssertionError(f"{phase} {label}: stats {st}")
        exempt = set() if cross_bitwise else _other_s(fixed_st["sched"],
                                                      st["sched"])
        gaps[label] = _compare_samples(f"{phase} {label} vs fixed S=4",
                                       fixed_out, out, exempt)
    (sync_out, sync_st), (ovl_out, ovl_st) = (runs["elastic-sync-R1"],
                                              runs["elastic-overlap-R1"])
    gaps["overlap-vs-sync"] = _compare_samples(
        f"{phase} overlap vs sync", sync_out, ovl_out,
        set() if cross_bitwise else _other_s(sync_st["sched"],
                                             ovl_st["sched"]))
    if not migrations:
        raise AssertionError(f"{phase}: no migration was checked")

    buckets = {}
    for s in (1, 2, 4):
        buckets[s] = profile_rounds(drift, tgrid, n, k, s,
                                    f"{phase}/bucket-{s}", per_call,
                                    timed=10)
    emit(phase, arch=cfg.name, layers=cfg.num_layers, card=CARD[0],
         cross_bucket_bitwise=cross_bitwise, migrations_checked=migrations,
         sample_gaps=gaps,
         buckets={s: {f: v[f] for f in (
             "wall_ms_per_round", "device_ms_per_round", "device_idle_share",
             "span_ms_per_round", "kernels_per_round")}
             for s, v in buckets.items()})
    return total


def _lane_run(drift, tgrid, n, k, mode, profile, rtol, eager=False,
              tau=0.4):
    """8 requests in ``mode`` through one engine at S=4 (``profile``: a
    lane profile or None for the homogeneous grid), on the graphs or the
    eager programs; (results, stats, wall s, launch counts)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request
    engine = _engine(drift, tgrid, n, k, 4, eager, rtol=rtol,
                     lane_profile=profile, lane_skip_tau=tau)
    for i in range(8):
        engine.submit(Request(rid=i, seed=100 + i, mode=mode))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        done = dict(engine.run_until_drained())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = _stats(engine)
    del engine
    torch.cuda.empty_cache()
    return done, st, wall, launch_counts()


def phase_lane_serve(cfg, params, phase="lane-serve"):
    """Heterogeneous lanes on the graphs at the launcher's latent, K=8,
    N=50, S=4, 8 requests, ``lane_profile="default"`` (cores 6-7 draft at
    factor 2, cores 4-7 skip-eligible): exact mode at rtol 0.05 bitwise
    the homogeneous graph run with equal rounds; adaptive and draft at rtol
    0.05, tau 0.4 (skips, rounds a request, s a round), each on the graphs
    bitwise its eager run; adaptive at rtol 0 bitwise exact at rtol 0.
    Every lane round launched the homogeneous round's kernels: one accept,
    and the backbone's per-call rmsnorm and flash counts."""
    import torch
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    n, k = 50, 8
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    per_call = per_call_launches(cfg)
    total: dict = {}
    recs, runs = {}, {}
    for label, mode, profile, rtol, eager in (
            ("homogeneous", "exact", None, 0.05, False),
            ("exact", "exact", "default", 0.05, False),
            ("adaptive", "adaptive", "default", 0.05, False),
            ("adaptive-eager", "adaptive", "default", 0.05, True),
            ("draft", "draft", "default", 0.05, False),
            ("draft-eager", "draft", "default", 0.05, True),
            ("exact-rtol0", "exact", "default", 0.0, False),
            ("adaptive-rtol0", "adaptive", "default", 0.0, False)):
        done, st, wall, counts = _lane_run(drift, tgrid, n, k, mode,
                                           profile, rtol, eager)
        _check_served(list(done.items()), 8, n, (1, 64, 16))
        rounds = st["rounds_total"]
        want = _want(per_call, rounds)
        if counts != want or st["dispatches"] != rounds:
            raise AssertionError(f"{phase} {label}: launches {counts} != "
                                 f"{want} ({rounds} rounds, dispatches "
                                 f"{st['dispatches']})")
        total = {name: total.get(name, 0) + c for name, c in counts.items()}
        runs[label] = (done, st)
        recs[label] = dict(
            mode=mode, rtol=rtol, programs=st["programs"], rounds=rounds,
            wall_s=wall, s_per_round=wall / rounds,
            lane_skips=st["lane_skips"],
            lane_promotes=st["lane_promotes"],
            lane_served_nonexact=st["lane_served_nonexact"],
            rounds_used=[done[r].rounds_used for r in sorted(done)],
            mean_rounds_used=sum(o.rounds_used for o in done.values()) / 8,
            accepted_cores=[done[r].accepted_core for r in sorted(done)],
            launches_per_round={name: c / rounds
                                for name, c in counts.items()})
        emit(phase + "/run", card=CARD[0], run=label, **recs[label])

    def same(a, b):
        da, db = runs[a][0], runs[b][0]
        for rid, x in da.items():
            y = db[rid]
            if not (torch.equal(x.sample, y.sample)
                    and (x.rounds_used, x.accepted_core)
                    == (y.rounds_used, y.accepted_core)):
                raise AssertionError(
                    f"{phase}: request {rid} {a} vs {b}: rounds "
                    f"{x.rounds_used}/{y.rounds_used}, max err "
                    f"{max_err(x.sample, y.sample)}")

    same("exact", "homogeneous")
    same("adaptive", "adaptive-eager")
    same("draft", "draft-eager")
    same("adaptive-rtol0", "exact-rtol0")
    if runs["exact"][1]["lane_skips"] or \
            runs["exact"][1]["lane_served_nonexact"]:
        raise AssertionError(f"{phase}: exact mode skipped a step")
    emit(phase, arch=cfg.name, layers=cfg.num_layers, card=CARD[0],
         bitwise={"exact_vs_homogeneous": True, "graph_vs_eager": True,
                  "adaptive_rtol0_vs_exact": True},
         skips={m: recs[m]["lane_skips"] for m in ("adaptive", "draft")},
         mean_rounds_used={m: recs[m]["mean_rounds_used"]
                           for m in ("exact", "adaptive", "draft")},
         s_per_round={m: recs[m]["s_per_round"] for m in recs})
    return total


def _accept_path_kernels(rows, m, p):
    """The round body's accept call (``ops.step_rectify_accept`` with a
    bool ``fire``, as ``core/chords.py`` makes it) at the round's shape
    under the profiler: it must launch exactly one device kernel, the
    accept kernel (no cast of ``fire``, no second pass)."""
    import torch
    from repro_torch.kernels.rectify.ops import step_rectify_accept
    gen = torch.Generator(device="cuda").manual_seed(6)
    lat, prev, dt, ds, fire = _rectify_operands(rows, m, p, gen)
    return check_one_kernel("accept path", "step_rectify_accept_kernel",
                            lambda: step_rectify_accept(
                                *lat, prev, dt, ds, fire, use_kernel=True))


def profile_static(drift, tgrid, n, k, s):
    """One ``ChordsEngine`` batch (s requests) under ``torch.profiler``:
    the device time per launch of its rectify kernel, which the
    ``ContinuousEngine`` profile never runs. The eager stream program: the
    profiler drops the records of the loop graph's kernels."""
    import torch
    from repro_torch.serve import ChordsEngine, Request
    from repro_torch.serve.executor import RoundExecutor
    static = ChordsEngine(drift, (64, 16), n, k, tgrid, max_batch=s,
                          rtol=0.05, device="cuda",
                          executor=RoundExecutor(drift, tgrid, n,
                                                 use_kernel=True,
                                                 eager=True))
    for i in range(s):
        static.submit(Request(rid=i, seed=400 + i))
    with torch.no_grad():
        events = profiled(lambda: None, static.step)
    rounds = static.total_rounds()
    ours = _port_kernels(events, rounds)
    step = _step_path_kernels(s * k, 64 * 16)
    emit("serve/profile-static", rounds=rounds, port_kernels=ours,
         step_path=step)
    got = ours.get("step_rectify_kernel", {}).get("launches_per_round")
    if got != 1:
        raise AssertionError(f"profile: step_rectify_kernel launched {got} "
                             f"times a round, want 1")


def _step_path_kernels(rows, m):
    """The stream round's step call (``ops.step_rectify`` with a bool
    ``fire``, as ``core/chords.py`` makes it) at the round's shape under
    the profiler: it must launch exactly one device kernel, the step
    kernel (no cast of ``fire``)."""
    import torch
    from repro_torch.kernels.rectify.ops import step_rectify
    gen = torch.Generator(device="cuda").manual_seed(7)
    lat, _, dt, ds, fire = _rectify_operands(rows, m, 1, gen)
    return check_one_kernel("step path", "step_rectify_kernel",
                            lambda: step_rectify(*lat, dt, ds, fire,
                                                 use_kernel=True))


def _check_served(done, count, n, shape):
    import torch
    if len(done) != count or len({rid for rid, _ in done}) != count:
        raise AssertionError(f"served {len(done)} of {count}")
    for rid, o in done:
        if not 1 <= o.rounds_used <= n:
            raise AssertionError(f"request {rid}: rounds_used {o.rounds_used}")
        if tuple(o.sample.shape) != tuple(shape) \
                or not bool(torch.isfinite(o.sample).all()):
            raise AssertionError(f"request {rid}: bad sample "
                                 f"{tuple(o.sample.shape)}")



# -- the sample-and-train slice: stream loop, baselines, training -------------

def _static_run(drift, tgrid, n, k, rtol, eager, seeds, profile=False):
    """``ChordsEngine`` (max_batch 4, latent (1, 64, 16)) on the graph or
    the eager stream program: a first batch builds the program (the graph's
    capture), then ``seeds`` are served with the kernels' device counts,
    the loop clock (graph) and the host readbacks taken over them.
    Returns (done, record, engine)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.device_loop.kernel import clock
    from repro_torch.serve import ChordsEngine, Request
    from repro_torch.serve.executor import RoundExecutor
    ex = RoundExecutor(drift, tgrid, n, use_kernel=True, eager=eager)
    eng = ChordsEngine(drift, (1, 64, 16), n, k, tgrid, max_batch=4,
                       rtol=rtol, executor=ex, device="cuda")
    eng.submit(Request(rid=-1, seed=999))
    with torch.no_grad():
        eng.step()
    prog = eng.sampler.program
    rb0, rr0, calls0 = eng.sampler.host_readbacks, prog.rounds_run, \
        len(eng.stats)
    for i, seed in enumerate(seeds):
        eng.submit(Request(rid=i, seed=seed))
    torch.cuda.synchronize()
    reset_launch_counts()
    ns0 = clock()[1]
    t0 = time.perf_counter()
    done = []
    with torch.no_grad():
        while eng.queue:
            done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_ms = (clock()[1] - ns0) / 1e6
    counts = launch_counts()
    rounds = prog.rounds_run - rr0
    calls = len(eng.stats) - calls0
    readbacks = eng.sampler.host_readbacks - rb0
    rec = dict(program=type(prog).__name__, calls=calls, rounds=rounds,
               wall_s=wall, s_per_round=wall / rounds,
               readbacks=readbacks, readbacks_per_call=readbacks / calls,
               launches=counts,
               build_s=getattr(prog, "build_s", None))
    if not eager:
        # the loop clock: device time inside the loop graphs (gaps between
        # a round's kernels counted busy)
        rec["device_ms_per_round"] = loop_ms / rounds
        rec["device_idle_share"] = 1.0 - loop_ms / 1e3 / wall
        rec["device_ms_from"] = "loop clock"
    elif profile:
        # the same eager program with a budget of 3 rounds, profiled (a
        # window of a whole batch, 25-50 rounds of ~2000 kernels each,
        # was followed by windows that lost most of their records)
        from repro_torch.serve.executor import EagerStream
        short = EagerStream(prog._fns, 3, prog.device)
        gen = torch.Generator(device="cuda").manual_seed(998)
        x0 = torch.randn((4, 1, 64, 16), generator=gen, device="cuda")
        live = torch.ones(4, dtype=torch.bool, device="cuda")
        box = {}

        def body():
            t1 = time.perf_counter()
            with torch.no_grad():
                short(x0, live)
            torch.cuda.synchronize()
            box["wall"] = time.perf_counter() - t1

        with torch.no_grad():
            events = profiled(lambda: short(x0, live), body)
        dev_s = sum(e.self_device_time_total for e in events) / 1e6
        rec["device_ms_per_round"] = dev_s * 1e3 / 3
        rec["device_idle_share"] = 1.0 - dev_s / box["wall"]
        rec["profiled_s_per_round"] = box["wall"] / 3
        rec["device_ms_from"] = "profiler, 3 rounds"
    return dict(done), rec, eng


def _while_vs_replays(prog, windows: int = 2) -> dict:
    """The stream graph's WHILE loop against its round graph replayed by the
    host, over windows of equal length: one launch of the loop program
    (rtol 0: N rounds, no early exit) against the captured init, N replays
    of the round graph and the captured finish, in turns (A B B A, twice),
    CUDA events around each window; the two windows' outputs bitwise."""
    import torch
    from repro_torch.kernels.device_loop import kernel as loop_kernel
    (sg,) = prog._shapes.values()
    n = prog.n

    def while_window():
        loop_kernel.graph_launch(sg._loop, sg.device.index or 0)

    def replay_window():
        sg._graphs[0].replay()
        for _ in range(n):
            sg._graphs[1].replay()
        sg._graphs[2].replay()

    ms = {"while": [], "replays": []}
    outs = {}
    for _ in range(windows):
        for label in ("while", "replays", "replays", "while"):
            fn = while_window if label == "while" else replay_window
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms[label].append(a.elapsed_time(b) / n)
            outs[label] = (sg.result.clone(), sg.rc.clone())
    if not (torch.equal(outs["while"][0], outs["replays"][0])
            and torch.equal(outs["while"][1], outs["replays"][1])):
        raise AssertionError("stream loop: WHILE and replays disagree")
    return {"window_rounds": n, "ms_per_round": ms,
            "median_while": sorted(ms["while"])[len(ms["while"]) // 2],
            "median_replays": sorted(ms["replays"])[len(ms["replays"])
                                                    // 2]}


def phase_stream_loop(cfg, params, phase="stream-loop"):
    """The batch stream program on ``chords-dit-xl`` at full width and
    depth through ``ChordsEngine`` (K=8, N=50, max_batch 4, latent
    (1, 64, 16)): the graph (one launch and one readback a batch) against
    the eager program at rtol 0.05 (8 requests, two batches) and 0 (4
    requests, 50 rounds): samples bitwise, equal rounds and cores; the step
    kernel's device-counted launches equal the rounds the loop ran; s a
    round and device idle share; then the WHILE loop against replays of
    its round graph."""
    import torch
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    n, k = 50, 8
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    per_call = per_call_launches(cfg)
    total = {}
    recs = {}
    for rtol, seeds in ((0.05, [300 + i for i in range(8)]),
                        (0.0, [400 + i for i in range(4)])):
        runs = {}
        for label, eager in (("graph", False), ("eager", True)):
            done, rec, eng = _static_run(drift, tgrid, n, k, rtol, eager,
                                         seeds, profile=True)
            _check_served(list(done.items()), len(seeds), n, (1, 64, 16))
            want = _want(per_call, rec["rounds"], accept=False,
                         loop=rec["rounds"] + rec["calls"])
            if rec["launches"] != want:
                raise AssertionError(f"{phase} {label} rtol {rtol}: "
                                     f"launches {rec['launches']} != {want}")
            if label == "graph":
                total = {name: total.get(name, 0) + c
                         for name, c in rec["launches"].items()}
                if rec["readbacks_per_call"] != 1:
                    raise AssertionError(f"{phase}: {rec['readbacks']} "
                                         f"readbacks in {rec['calls']} calls")
                if rtol == 0.0:
                    rec["while_vs_replays"] = _while_vs_replays(
                        eng.sampler.program)
            runs[label] = done
            recs[f"{label}-rtol{rtol}"] = rec
            emit(phase + "/run", card=CARD[0], run=label, rtol=rtol, **rec)
            del eng
        for rid, a in runs["eager"].items():
            b = runs["graph"][rid]
            if not (torch.equal(a.sample, b.sample)
                    and (a.rounds_used, a.accepted_core)
                    == (b.rounds_used, b.accepted_core)):
                raise AssertionError(
                    f"{phase} rtol {rtol}: request {rid} graph vs eager "
                    f"(max err {max_err(a.sample, b.sample)}, rounds "
                    f"{b.rounds_used}/{a.rounds_used})")
        torch.cuda.empty_cache()
    emit(phase, arch=cfg.name, layers=cfg.num_layers, card=CARD[0],
         graph_vs_eager_bitwise=True,
         summary={key: {f: r.get(f) for f in (
             "rounds", "calls", "readbacks_per_call", "s_per_round",
             "device_ms_per_round", "device_idle_share")}
             for key, r in recs.items()},
         while_vs_replays=recs["graph-rtol0.0"]["while_vs_replays"])
    return total


def phase_baselines(cfg, params, phase="baselines"):
    """The paper's baselines on ``chords-dit-xl`` at full width and depth
    (one latent (1, 64, 16), N=50): ParaDiGMS (window 8, tol 2e-3) and SRDS
    (5 segments, tol 1e-3) with the kernels and with the plain drift:
    outputs within the bf16 backbone tolerance of each other, both finite;
    rounds, speedup N / rounds, s a round, and each against the sequential
    solve (latent RMSE)."""
    import torch
    from repro_torch.core import (paradigms_sample, sequential_sample,
                                  srds_sample, uniform_tgrid)
    from repro_torch.diffusion import make_drift
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n = 50
    tgrid = uniform_tgrid(n, device="cuda")
    drift_k = make_drift(params, cfg.replace(use_kernels=True))
    drift_p = make_drift(params, cfg)
    gen = torch.Generator(device="cuda").manual_seed(21)
    x0 = torch.randn(1, 64, 16, generator=gen, device="cuda")
    with torch.no_grad():
        seq = sequential_sample(drift_k, x0, tgrid, device="cuda")
    torch.cuda.synchronize()
    total, out = {}, {}
    for name, fn in (
            ("paradigms", lambda d: paradigms_sample(d, x0, tgrid, window=8,
                                                     device="cuda")),
            ("srds", lambda d: srds_sample(d, x0, tgrid, num_segments=5,
                                           device="cuda"))):
        reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            res_k = fn(drift_k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        with torch.no_grad():
            res_p = fn(drift_p)
        for res in (res_k, res_p):
            if tuple(res.output.shape) != (1, 64, 16) \
                    or not bool(torch.isfinite(res.output).all()):
                raise AssertionError(f"{phase} {name}: bad output")
        torch.testing.assert_close(res_k.output, res_p.output,
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
        total = {key: total.get(key, 0) + c for key, c in counts.items()}
        out[name] = dict(
            rounds=res_k.rounds, rounds_plain=res_p.rounds,
            iters=res_k.iters, speedup=res_k.speedup, wall_s=wall,
            s_per_round=wall / res_k.rounds, launches=counts,
            max_abs_err_vs_plain=max_err(res_k.output, res_p.output),
            rmse_vs_sequential=float(torch.sqrt(
                ((res_k.output - seq) ** 2).mean())))
    emit(phase, arch=cfg.name, layers=cfg.num_layers, card=CARD[0],
         seq_rms=float(torch.sqrt((seq ** 2).mean())), **out)
    return total


def _load_example(name):
    import importlib.util
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_full_width(steps: int = 10) -> dict:
    """``chords-dit-xl``'s full widths cut to 4 layers (bf16 compute and
    storage, f32 master weights): ``steps`` AdamW steps on one fixed batch
    (8 latents of (64, 16) from a Gaussian mixture, fixed t and noise). The
    loss must be finite and fall."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import GaussianMixture
    from repro_torch.diffusion import diffusion_loss_from, init_wrapper
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.utils.tree import (tree_flatten, tree_map,
                                        tree_unflatten)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("chords-dit-xl").replace(num_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(31)
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      init_wrapper(cfg, 16, generator=gen, device="cuda"))
    leaves, treedef = tree_flatten(params)
    gm = GaussianMixture.random(gen, num_modes=4, dim=16, device="cuda")
    x1 = gm.sample_data(gen, 8 * 64).reshape(8, 64, 16)
    t = torch.rand((8, 1, 1), generator=gen, device="cuda")
    eps = torch.randn(x1.shape, generator=gen, device="cuda")
    opt = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=steps,
                      weight_decay=0.0)
    state = init_state(params, opt)
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = diffusion_loss_from(params, cfg, x1, t, eps)
        grads = tree_unflatten(treedef, list(torch.autograd.grad(
            loss, tree_flatten(params)[0], allow_unused=True,
            materialize_grads=True)))
        with torch.no_grad():
            params, state, _ = apply_updates(params, grads, state, opt)
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"full-width training: losses {losses}")
    return dict(d_model=cfg.d_model, heads=cfg.num_heads,
                head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
                layers=cfg.num_layers, cut="depth 36 -> 4 layers",
                params_m=sum(x.numel() for x in leaves) / 1e6,
                batch=[8, 64, 16], steps=steps, losses=losses,
                s_per_step=step_s, s_per_step_median=sorted(step_s)[
                    len(step_s) // 2],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _train_step_card_vs_cpu() -> dict:
    """One f32 train step of the micro config (4 layers, d_model 128) on
    the card and on the CPU from the same parameters, batch, t and noise:
    loss within 1e-5 relative and every gradient within 1e-5 relative in
    the L2 norm (f32 sums taken in other orders). The updated parameters
    differ by at most 2 lr an element: AdamW's first step moves an element
    by lr * g / (|g| + eps), about lr * sign(g), so an element whose
    gradient is at rounding level may move the other way on the other
    device (their relative L2 gap is printed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.diffusion import diffusion_loss_from, init_wrapper
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                        tree_unflatten)
    cfg = get_config("chords-dit-xl", reduced=True)
    gen = torch.Generator().manual_seed(41)
    base = init_wrapper(cfg, 8, generator=gen, device="cpu")
    with torch.no_grad():
        base["out_proj"].normal_(0.0, 0.05, generator=gen)
    x1 = torch.randn(4, 8, 8, generator=gen)
    t = torch.rand(4, 1, 1, generator=gen)
    eps = torch.randn(4, 8, 8, generator=gen)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, weight_decay=0.1)
    res = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda p: p.detach().to(dev).requires_grad_(),
                          base)
        leaves, treedef = tree_flatten(params)
        loss = diffusion_loss_from(params, cfg, x1.to(dev), t.to(dev),
                                   eps.to(dev))
        grads = tree_unflatten(treedef, list(torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True)))
        with torch.no_grad():
            new, _, _ = apply_updates(params, grads,
                                      init_state(params, opt), opt)
        res[dev] = (float(loss.detach()),
                    [g.detach().cpu().double() for g in tree_leaves(grads)],
                    [p.detach().cpu().double() for p in tree_leaves(new)])
    (lc, gc, pc), (lg, gg, pg) = res["cpu"], res["cuda"]

    def worst(a, b):
        return max(float((x - y).norm() / max(float(y.norm()), 1e-30))
                   for x, y in zip(a, b))
    moved = [(x - y).abs() for x, y in zip(pg, pc)]
    out = dict(loss_cpu=lc, loss_card=lg, loss_rel=abs(lg - lc) / abs(lc),
               grad_rel_l2=worst(gg, gc), param_rel_l2=worst(pg, pc),
               param_max_abs=max(float(m.max()) for m in moved),
               params_apart=sum(int((m > 1e-3 * opt.lr).sum())
                                for m in moved),
               params=sum(m.numel() for m in moved), tol=1e-5,
               param_tol_abs=2 * opt.lr)
    if not (max(out["loss_rel"], out["grad_rel_l2"]) <= 1e-5
            and out["param_max_abs"] <= 2 * opt.lr):
        raise AssertionError(f"train step card vs CPU: {out}")
    return out


def phase_train_denoiser(phase="train-denoiser"):
    """(a) The example's reduced denoiser (``chords-dit-micro``, latent
    (8, 8)) trained on the card for 300 AdamW steps, checkpointed every 100
    (the newest restore bitwise), then sampled with the kernels: CHORDS at
    K=8, ParaDiGMS (window 8) and SRDS (5 segments) against the sequential
    solve at N=50 (speedup, latent RMSE); (b) full widths, 4 layers; (c) a
    train step card vs CPU. Returns the kernels' launches of (a)'s
    sampling."""
    import tempfile

    import torch
    from repro_torch.core import (paradigms_sample, sequential_sample,
                                  srds_sample, uniform_tgrid)
    from repro_torch.diffusion import make_drift
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.utils.tree import tree_leaves
    ex = _load_example("torch_train_denoiser.py")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        args = ex.parse_args(["--steps", "300", "--ckpt-dir", tmp])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, cfg, _, losses, ckpt = ex.train(
            args, dev, log=lambda *a: None)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        steps = sorted(os.listdir(tmp))
        restored, step = ckpt.restore_latest({"params": params,
                                              "opt": state})
        want = tree_leaves({"params": params, "opt": state})
        got = tree_leaves(restored)
        if step != args.steps or len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{phase}: restore of step {step} is not "
                                 f"bitwise the trained state")
    if not all(math.isfinite(v) for v in losses) \
            or not sum(losses[-20:]) < sum(losses[:20]):
        raise AssertionError(f"{phase}: losses {losses[:3]} .. "
                             f"{losses[-3:]}")
    kcfg = cfg.replace(use_kernels=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    speedup, rmse, rel = ex.sample(params, kcfg, args, dev,
                                   log=lambda *a: None)
    torch.cuda.synchronize()
    chords_s = time.perf_counter() - t0
    n = args.sample_steps
    tg = uniform_tgrid(n, 0.98, device="cuda")
    x0 = torch.randn((4, args.seq, args.latent_dim),
                     generator=torch.Generator(device="cuda").manual_seed(3),
                     device="cuda")
    quality = {"chords": dict(cores=args.cores, speedup=speedup,
                              rmse=rmse, rel_rmse=rel, wall_s=chords_s)}
    with torch.no_grad():
        drift = make_drift(params, kcfg)
        seq = sequential_sample(drift, x0, tg, device="cuda")
        scale = float(torch.sqrt((seq ** 2).mean()))
        for name, fn in (
                ("paradigms", lambda: paradigms_sample(drift, x0, tg,
                                                       window=8,
                                                       device="cuda")),
                ("srds", lambda: srds_sample(drift, x0, tg, num_segments=5,
                                             device="cuda"))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            e = float(torch.sqrt(((res.output - seq) ** 2).mean()))
            quality[name] = dict(speedup=res.speedup, rounds=res.rounds,
                                 iters=res.iters, rmse=e, rel_rmse=e / scale,
                                 wall_s=time.perf_counter() - t0)
    counts = launch_counts()
    for name, q in quality.items():
        if not (math.isfinite(q["rmse"]) and q["speedup"] > 0):
            raise AssertionError(f"{phase} {name}: {q}")
    emit(phase, card=CARD[0], arch=cfg.name, latent=[args.seq,
                                                    args.latent_dim],
         steps=args.steps, train_s=train_s, s_per_step=train_s / args.steps,
         loss_first=losses[0], loss_last=losses[-1],
         loss_mean_first20=sum(losses[:20]) / 20,
         loss_mean_last20=sum(losses[-20:]) / 20, checkpoints=steps,
         restore_bitwise=True, sample_steps=n, quality=quality,
         launches=counts)
    emit(phase + "/full-width", card=CARD[0], **_train_full_width())
    emit(phase + "/card-vs-cpu", card=CARD[0], **_train_step_card_vs_cpu())
    return counts


# -- lm-generate ----------------------------------------------------------------

# full width and depth, one model at a time; traffic: a batch of prompts
# from seed 1, then greedy decode steps (``greedy_generate``'s loop)
LM_FULL = ("gemma-7b", "qwen2-vl-7b", "olmoe-1b-7b")
LM_REDUCED = ("qwen1.5-0.5b", "qwen1.5-32b", "gemma-7b", "internlm2-1.8b",
              "qwen2-vl-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = 4, 512, 1024, 64
LM_REL_L2 = 2e-2      # kernels against plain: the smoke's bf16 bound
LM_F32_ATOL = 2e-5    # card against CPU, f32 prefill (attention contract)
# card against CPU, decode: both sides read the bf16 cache to within one ulp,
# where an f32 k/v rounds to the other neighbour on the card; read at most
# 5.3e-4 on the H100 (qwen1.5-32b reduced), where an off-by-one decode mask
# or cache write moves the logits by 0.14 or more
LM_DECODE_ATOL = 2e-3


def _lm_norms_off_one(params, gen):
    """Draw the norm weights (``init_model`` gives ones) as 1 + 0.1·N in
    place, so that the kernel and plain paths both read them."""
    import torch
    with torch.no_grad():
        for name, w in params.named_parameters():
            if name.endswith(("ln1", "ln2", "final_norm")):
                w.copy_(1.0 + 0.1 * torch.randn(w.shape, generator=gen,
                                                device=w.device))


def lm_launches(cfg):
    """Kernel launches of one prefill and of one decode step: dense and VLM
    blocks route ln1, ln2 and (prefill only) attention; the final norm
    stays plain; MoE blocks take no kernel route (the reference's
    choice)."""
    if cfg.family == "moe":
        none = {"rmsnorm": 0, "flash_attention": 0}
        return none, dict(none)
    n = cfg.num_layers
    return ({"rmsnorm": 2 * n, "flash_attention": n},
            {"rmsnorm": 2 * n, "flash_attention": 0})


def _lm_counts(want, what):
    from repro_torch.kernels import launch_counts
    got = launch_counts()
    if any(got[name] != c for name, c in want.items()):
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return got


def _lm_generate(cfg, params, prompt, steps, counts=None, teacher=None):
    """Prefill, then ``steps`` greedy decode steps, as ``greedy_generate``
    runs them. ``teacher`` (tokens [B, steps]) feeds those tokens instead
    of the argmax. With ``counts`` ({"prefill", "decode"} launches wanted),
    the kernels' device counters are reset before and read after the
    prefill and the decode loop, and held to them exactly. Returns the
    tokens, the last-position logits of the prefill and of every step
    (f32), the cache right after the prefill (a copy), and per-step ms
    (CUDA events, the host not waiting inside the loop)."""
    import torch
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serve import make_decode_step, make_prefill
    prefill = make_prefill(cfg, LM_MAX_LEN)
    decode = make_decode_step(cfg)
    total = {"rmsnorm": 0, "flash_attention": 0}
    with torch.no_grad():
        if counts:
            reset_launch_counts()
        logits, cache = prefill(params, prompt)
        if counts:
            got = _lm_counts(counts["prefill"], f"{cfg.name} prefill")
            total = {n: total[n] + got[n] for n in total}
        kv = (cache["k"][:, :, :prompt.shape[1]].clone(),
              cache["v"][:, :, :prompt.shape[1]].clone())
        last = [logits[:, -1].float()]
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks = [tok]
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(steps + 1)]
        if counts:
            reset_launch_counts()
        marks[0].record()
        for i in range(steps):
            if teacher is not None:
                tok = teacher[:, i:i + 1]
            logits, cache = decode(params, tok, cache)
            marks[i + 1].record()
            last.append(logits[:, -1].float())
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok)
        if counts:
            got = _lm_counts({n: c * steps for n, c in
                              counts["decode"].items()},
                             f"{cfg.name} {steps} decode steps")
            total = {n: total[n] + got[n] for n in total}
        torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    return dict(tokens=torch.cat(toks, dim=1), logits=last, kv=kv,
                step_ms=ms, cache=cache, launches=total)


def _lm_decode_profile(cfg, params, cache, tok, steps: int = 8):
    """Wall, host and device time of ``steps`` decode steps continuing
    ``cache``: unprofiled first (host clock; host ms is the enqueue before
    the final synchronize), then a profiler window of as many steps (device
    kernel time). Idle share = 1 - device / unprofiled wall."""
    import torch
    from repro_torch.serve import make_decode_step
    decode = make_decode_step(cfg)
    state = {"tok": tok, "cache": cache}

    def run():
        for _ in range(steps):
            logits, state["cache"] = decode(params, state["tok"],
                                            state["cache"])
            state["tok"] = torch.argmax(logits[:, -1:], dim=-1).to(
                torch.int32)

    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = profiled(run, run)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms_per_step=wall_ms, host_ms_per_step=host * 1e3 / steps,
                device_ms_per_step=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall_ms),
                kernels_per_step=sum(e.count for e in events) / steps,
                top_kernels={e.key[:50]: e.self_device_time_total / 1e3
                             / steps for e in top})


def _lm_full(arch):
    """One full-width model: kernels against plain (teacher-forced),
    exact launch counts, determinism, times and memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import make_prefill
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch).replace(use_kernels=True)
    t0 = time.perf_counter()
    params = api.init_model(cfg, 0, device="cuda")
    _lm_norms_off_one(params, torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    param_gb = sum(p.numel() * p.element_size()
                   for p in params.parameters()) / 1e9
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=gen, device="cuda")
    pre, dec = lm_launches(cfg)
    # the main path: kernels, launches counted
    run = _lm_generate(cfg, params, prompt, LM_STEPS,
                       counts={"prefill": pre, "decode": dec})
    toks = run["tokens"]
    if tuple(toks.shape) != (LM_BATCH, LM_STEPS + 1) \
            or not all(bool(torch.isfinite(x).all()) for x in run["logits"]):
        raise AssertionError(f"{arch}: tokens {tuple(toks.shape)} or "
                             f"non-finite logits")
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: token ids out of the vocabulary")
    # the plain path, fed the kernel path's tokens
    plain = _lm_generate(cfg.replace(use_kernels=False), params, prompt,
                         LM_STEPS, teacher=toks[:, :LM_STEPS])
    errs = [rel_l2(a, b) for a, b in zip(run["logits"], plain["logits"])]
    top1 = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
            for a, b in zip(run["logits"], plain["logits"])]
    kv_err = max(max_err(a, b) for a, b in zip(run["kv"], plain["kv"]))
    if not max(errs) <= LM_REL_L2:
        raise AssertionError(f"{arch}: kernels against plain, relative L2 "
                             f"{max(errs)} (step {errs.index(max(errs))}) > "
                             f"{LM_REL_L2}")
    del plain
    # determinism: a second kernel-path generation, bitwise
    again = _lm_generate(cfg, params, prompt, LM_STEPS)
    if not torch.equal(again["tokens"], toks):
        raise AssertionError(f"{arch}: a second generation differs")
    same_logits = all(torch.equal(a, b) for a, b in
                      zip(run["logits"], again["logits"]))
    # times: prefill (median of 5), decode (median over the 64 steps), a
    # profiled decode window continuing the second generation's cache
    prefill = make_prefill(cfg, LM_MAX_LEN)
    with torch.no_grad():
        prefill_ms = median_ms(lambda: prefill(params, prompt), iters=5,
                               reps=1, warmup=1)
        pre_events = profiled(lambda: prefill(params, prompt),
                              lambda: prefill(params, prompt))
    pre_busy = sum(e.self_device_time_total for e in pre_events) / 1e3
    flash_ms = sum(e.self_device_time_total for e in pre_events
                   if "flash_fwd" in e.key) / 1e3
    prof = _lm_decode_profile(cfg, params, again["cache"],
                              again["tokens"][:, -1:])
    step_ms = run["step_ms"][len(run["step_ms"]) // 2]
    kv_gb = 2 * cfg.num_layers * LM_BATCH * LM_MAX_LEN * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2 / 1e9
    rec = dict(
        arch=arch, family=cfg.family, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, vocab=cfg.vocab_size,
        params_b=api.param_count(cfg) / 1e9, param_gb=param_gb,
        kv_cache_gb=kv_gb, init_s=init_s, init_peak_gb=init_peak_gb,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        batch=LM_BATCH, prompt=LM_PROMPT, max_len=LM_MAX_LEN,
        decode_steps=LM_STEPS, launches=run["launches"],
        launches_per_prefill=pre, launches_per_decode_step=dec,
        prefill_ms=prefill_ms, prefill_device_ms=pre_busy,
        prefill_flash_device_ms=flash_ms,
        prefill_top_kernels={e.key[:50]: e.self_device_time_total / 1e3
                             for e in sorted(pre_events, key=lambda e:
                                             -e.self_device_time_total)[:6]},
        decode_ms_per_step=step_ms,
        decode_tokens_per_s=LM_BATCH * 1e3 / step_ms,
        decode_ms_min_max=[run["step_ms"][0], run["step_ms"][-1]],
        rel_l2_vs_plain_prefill=errs[0],
        rel_l2_vs_plain_decode_max=max(errs[1:]),
        top1_agreement_prefill=top1[0],
        top1_agreement_decode=sum(top1[1:]) / LM_STEPS,
        kv_cache_max_abs_err_vs_plain=kv_err, tokens_bitwise_rerun=True,
        logits_bitwise_rerun=same_logits,
        first_tokens=toks[0, :8].tolist(), decode_profile=prof)
    del params, run, again
    torch.cuda.empty_cache()
    return rec


def _lm_card_vs_cpu(arch):
    """The reduced (f32) config: prefill and 8 decode steps on the card with
    the kernels (f32 flash and rmsnorm routes) against the CPU's plain
    path, same weights, decode fed the CPU's greedy tokens."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import api
    from repro_torch.serve import make_decode_step, make_prefill
    cfg = get_config(arch, reduced=True)
    cpu_params = api.init_model(cfg, 0, device="cpu")
    _lm_norms_off_one(cpu_params, torch.Generator().manual_seed(2))
    gpu_params = copy.deepcopy(cpu_params).to("cuda")
    prompt = torch.randint(0, cfg.vocab_size, (2, 77),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    pre = lm_launches(cfg)[0]
    for where, dev, params, uk in (("cpu", "cpu", cpu_params, False),
                                   ("card", "cuda", gpu_params, True)):
        c = cfg.replace(use_kernels=uk)
        toks = out["cpu"]["tokens"] if where == "card" else None
        with torch.no_grad():
            if where == "card":
                reset_launch_counts()
            logits, cache = make_prefill(c, 96)(params, prompt.to(dev))
            if where == "card":
                _lm_counts(pre, f"{arch} reduced prefill")
            res = {"logits": [logits.cpu()], "tokens": []}
            tok = torch.argmax(logits[:, -1:], dim=-1)
            for i in range(8):
                if toks is not None:
                    tok = toks[i].to(dev)
                res["tokens"].append(tok.cpu())
                logits, cache = make_decode_step(c)(params, tok, cache)
                res["logits"].append(logits.cpu())
                tok = torch.argmax(logits[:, -1:], dim=-1)
        out[where] = res
    a, b = out["card"]["logits"], out["cpu"]["logits"]
    pre_err = max_err(a[0], b[0])
    if not pre_err <= LM_F32_ATOL:
        raise AssertionError(f"{arch} reduced: prefill card vs cpu {pre_err}")
    for x, y in zip(a[1:], b[1:]):
        torch.testing.assert_close(x, y, rtol=0, atol=LM_DECODE_ATOL)
    return dict(prefill_max_abs_err=pre_err,
                decode_max_abs_err=max(max_err(x, y)
                                       for x, y in zip(a[1:], b[1:])))


def phase_lm_generate(phase="lm-generate"):
    """LM serving through ``repro_torch.serve``'s prefill and KV-cache
    decode at full width and depth (``gemma-7b``, ``qwen2-vl-7b``,
    ``olmoe-1b-7b``; random bf16 weights from seed 0), then every reduced
    LM config card against CPU in f32."""
    counts = {"rmsnorm": 0, "flash_attention": 0}
    for arch in LM_FULL:
        t0 = time.perf_counter()
        rec = _lm_full(arch)
        counts = {n: counts[n] + rec["launches"][n] for n in counts}
        emit(phase, card=CARD[0], seconds=time.perf_counter() - t0, **rec)
    t0 = time.perf_counter()
    reduced = {arch: _lm_card_vs_cpu(arch) for arch in LM_REDUCED}
    emit(phase + "/card-vs-cpu", card=CARD[0], prefill_atol=LM_F32_ATOL,
         decode_atol=LM_DECODE_ATOL, configs=reduced,
         seconds=time.perf_counter() - t0)
    return {name: counts.get(name, 0) for name in SOURCES}


# -- main -----------------------------------------------------------------------

SOURCES = {
    "fused_step_rectify": ("src/repro_torch/csrc/rectify.cu",
                           "src/repro/kernels/rectify/kernel.py:70"),
    "fused_step_rectify_accept": ("src/repro_torch/csrc/rectify.cu",
                                  "src/repro/kernels/rectify/kernel.py:145"),
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:38"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:86"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_scan.cu",
                  "src/repro/kernels/ssd_scan/kernel.py:63"),
    # not a Pallas kernel: the cond of the multi-round lax.while_loop
    "device_loop": ("src/repro_torch/csrc/device_loop.cu",
                    "src/repro/serve/executor.py:353"),
}
# the kernels each serving path runs (the hybrid's add ssd_chunk)
_CONTINUOUS = {"fused_step_rectify_accept", "rmsnorm", "flash_attention"}
SERVE_KERNELS = {"serve": _CONTINUOUS | {"fused_step_rectify"},
                 "overlap-serve": _CONTINUOUS,
                 "device-loop": _CONTINUOUS | {"device_loop"},
                 "elastic-serve": _CONTINUOUS | {"device_loop"},
                 "lane-serve": _CONTINUOUS,
                 "hybrid-serve": _CONTINUOUS | {"fused_step_rectify",
                                                "ssd_chunk"},
                 "hybrid-device-loop": _CONTINUOUS | {"device_loop",
                                                      "ssd_chunk"},
                 "stream-loop": {"fused_step_rectify", "rmsnorm",
                                 "flash_attention", "device_loop"},
                 "baselines": {"rmsnorm", "flash_attention"},
                 "train-denoiser": {"rmsnorm", "flash_attention"},
                 "lm-generate": {"rmsnorm", "flash_attention"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch from "
              f"{os.path.join(ROOT, 'src')}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    records: dict = {}
    if "kernels" in phases:
        phase_kernels(records)
    if "parity" in phases:
        phase_parity()
    launches = {name: 0 for name in SOURCES}
    # per arch: its drift phase, then its serving paths in order. The
    # DiT's stream-loop and baselines come after the hybrid (the model
    # built again): placed before it, the hybrid's one-kernel profiler
    # check, later in the process, lost most of its records (two whole
    # smokes), which the phases alone in a short process did not show
    for arch, drift_phase, paths in (
            ("chords-dit-xl", "drift", (("serve", phase_serve),
                                        ("overlap-serve",
                                         phase_overlap_serve),
                                        ("device-loop", phase_device_loop),
                                        ("elastic-serve",
                                         phase_elastic_serve),
                                        ("lane-serve", phase_lane_serve))),
            ("zamba2-2.7b", "hybrid-drift", (("hybrid-serve", phase_serve),
                                             ("hybrid-device-loop",
                                              phase_device_loop))),
            ("chords-dit-xl", None, (("stream-loop", phase_stream_loop),
                                     ("baselines", phase_baselines)))):
        if arch == "zamba2-2.7b" and "ssd" in phases:
            phase_ssd()
        if not ({drift_phase} | {p for p, _ in paths}) & set(phases):
            continue
        torch.cuda.reset_peak_memory_stats()
        cfg, params = build_model(arch)
        if drift_phase in phases:
            phase_drift(cfg, params, drift_phase)
        for path, run in paths:
            if path not in phases:
                continue
            counts = run(cfg, params, path)
            missing = [n for n in SERVE_KERNELS[path] if not counts[n]]
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"{path} path: {missing}")
            launches = {n: launches[n] + counts[n] for n in launches}
        del cfg, params
        torch.cuda.empty_cache()
        if drift_phase == "hybrid-drift" and drift_phase in phases:
            phase_hybrid_f32()
            torch.cuda.empty_cache()
    for path, run in (("train-denoiser", phase_train_denoiser),
                      ("lm-generate", phase_lm_generate)):
        if path not in phases:
            continue
        counts = run()
        missing = [n for n in SERVE_KERNELS[path] if not counts[n]]
        if missing:
            raise AssertionError(f"kernels never launched on the "
                                 f"{path} path: {missing}")
        launches = {n: launches[n] + counts[n] for n in launches}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        rec = records.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "plain_ms": rec.get("plain_ms"), "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms")})
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
