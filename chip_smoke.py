#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   — card name, ``nvidia-smi`` name and power limit, ``nvcc``;
2. build    — every CUDA source of the port built with ``nvcc`` (in
              parallel) into ``build/kernels/``;
3. kernels  — each kernel wrapper against its plain PyTorch version at the
              serving shapes plus a sweep, with its stated tolerance, and
              timed (median of CUDA-event timings) beside the plain
              version, one library call where one computes the same
              function, and its bound (bytes or operations at the H100's
              published peaks);
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
              device time goes and how long the device sits idle.

The line before the last holds ``{"kernels": [...]}``; the line before that
the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. With no GPU, or without the repository's
``src/`` beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "parity", "drift", "serve")

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


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# -- phase 1 ------------------------------------------------------------------

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
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         nvidia_smi=smi.stdout.strip().splitlines()[0])
    return smi.stdout.strip().splitlines()[0]


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
    import torch
    from repro_torch.kernels.rectify import kernel as K
    from repro_torch.kernels.rectify.ref import (
        fused_step_rectify_accept_ref, fused_step_rectify_ref)
    results = []
    # (rows, M, prev rows): the serving grid S*K=32 rows of M = 1*64*16,
    # prev shared by each slot's 8 cores; a per-row prev; a long tail
    for rows, m, p in ((32, 1024, 4), (32, 1024, 32), (64, 1_000_003, 64)):
        lat, prev, dt, ds, fire = _rectify_operands(rows, m, p, gen)
        out = K.fused_step_rectify(*lat, dt, ds, fire)
        ref = fused_step_rectify_ref(*lat, dt, ds, fire)
        if not torch.equal(out, ref):
            raise AssertionError(f"rectify [{rows},{m}] not bitwise: max "
                                 f"err {max_err(out, ref)}")
        out2, e2, o2 = K.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
        ref2, re2, ro2 = fused_step_rectify_accept_ref(*lat, prev, dt, ds,
                                                       fire)
        torch.cuda.synchronize()
        if not torch.equal(out2, ref2):
            raise AssertionError(f"rectify accept [{rows},{m}] out not "
                                 f"bitwise: {max_err(out2, ref2)}")
        for a, b in ((e2, re2), (o2, ro2)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
        results.append({"rows": rows, "m": m, "prev_rows": p,
                        "out_bitwise": True,
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
    records["fused_step_rectify"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=err, shape=[rows, m])
    ms = median_ms(lambda: K.fused_step_rectify_accept(*lat, prev, dt, ds,
                                                       fire))
    plain = median_ms(lambda: fused_step_rectify_accept_ref(
        *lat, prev, dt, ds, fire))
    a = K.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
    b = fused_step_rectify_accept_ref(*lat, prev, dt, ds, fire)
    err = max(max_err(x, y) for x, y in zip(a, b))
    nbytes = 4 * (7 * rows * m + p * m + 5 * rows)
    bms, by = bound_ms(nbytes, 12 * rows * m, "float32")
    records["fused_step_rectify_accept"] = dict(
        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err=err, shape=[rows, m, p])
    emit("kernels/rectify", cases=results)


def check_rmsnorm(gen, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    cases = []
    for rows, d, dt, wdt, tol in ((2048, 3072, torch.bfloat16,
                                   torch.bfloat16, 5e-2),
                                  (2048, 3072, torch.bfloat16, torch.float32,
                                   5e-2),
                                  (1000, 3072, torch.float32, torch.float32,
                                   1e-5),
                                  (37, 128, torch.float32, torch.float32,
                                   1e-5),
                                  (333, 4096, torch.bfloat16, torch.bfloat16,
                                   5e-2)):
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")) \
            .to(wdt)
        out, ref = K.rmsnorm(x, w), rmsnorm_ref(x, w)
        err = max_err(out, ref)
        if not err <= tol:
            raise AssertionError(f"rmsnorm {rows}x{d} {dt}: err {err} > "
                                 f"{tol}")
        cases.append({"rows": rows, "d": d, "dtype": str(dt),
                      "w_dtype": str(wdt), "max_abs_err": err, "tol": tol})
    rows, d = 2048, 3072
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    ms = median_ms(lambda: K.rmsnorm(x, w))
    plain = median_ms(lambda: rmsnorm_ref(x, w))
    lib = median_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
    bms, by = bound_ms(2 * (2 * rows * d + d), 4 * rows * d, "bfloat16")
    records["rmsnorm"] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                              bound_by=by, library_ms=lib,
                              max_abs_err=max_err(K.rmsnorm(x, w),
                                                  rmsnorm_ref(x, w)),
                              shape=[rows, d])
    emit("kernels/rmsnorm", cases=cases)


def _flash_flops(b, sq, sk, h, dh, causal):
    if not causal:
        return 4.0 * b * h * sq * sk * dh
    pairs = sum(min(q + 1, sk) for q in range(sq))
    return 4.0 * b * h * pairs * dh


def check_flash(gen, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cases = []
    sweep = [  # (b, sq, sk, h, kv, dh, causal)
        (32, 64, 64, 24, 24, 128, False),   # the serving shape
        (2, 1024, 1024, 24, 24, 128, False),
        (2, 1024, 1024, 24, 8, 128, True),  # GQA, causal, many KV tiles
        (2, 200, 200, 24, 8, 128, True),    # tails
        (3, 200, 333, 4, 2, 64, False),
        (4, 77, 77, 4, 4, 32, True),
    ]
    for b, sq, sk, h, kv, dh, causal in sweep:
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn(b, sq, h, dh, generator=gen, device="cuda").to(dt)
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
            cases.append({"shape": [b, sq, sk, h, kv, dh], "causal": causal,
                          "dtype": str(dt), "max_abs_err": err, "tol": tol})
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
    emit("kernels/flash_attention", cases=cases)


def phase_kernels(records):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_rectify(gen, records)
    check_rmsnorm(gen, records)
    check_flash(gen, records)
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


# -- phases 4 and 5 -------------------------------------------------------------

def build_model(seed: int = 0):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper
    cfg = get_config("chords-dit-xl")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_wrapper(cfg, 16, generator=gen, device="cuda")
    # the reference initializes out_proj to zeros (a zero drift); random
    # values make the smoke's drift, and so its sampling, non-trivial
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.02, generator=gen)
    return cfg, params


def phase_drift(cfg, params):
    import torch
    from repro_torch.diffusion import denoise
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(32, 64, 16, generator=gen, device="cuda")
    t = torch.rand(32, generator=gen, device="cuda")
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
    L = cfg.num_layers
    if counts["rmsnorm"] != 2 * L + 1 or counts["flash_attention"] != L:
        raise AssertionError(f"drift launch counts {counts}")
    torch.testing.assert_close(out_k, out_p, rtol=8e-2, atol=5e-2)
    with torch.no_grad():
        t_k = median_ms(lambda: denoise(params, cfg.replace(use_kernels=True),
                                        x, t), iters=5, reps=1, warmup=1)
        t_p = median_ms(lambda: denoise(params, cfg, x, t), iters=5, reps=1,
                        warmup=1)
    emit("drift", layers=L, batch=list(x.shape),
         max_abs_err=max_err(out_k, out_p), kernels_ms=t_k, plain_ms=t_p,
         launches_per_call=counts,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_serve(cfg, params):
    import torch
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ChordsEngine, ContinuousEngine, Request
    n, k, s, rtol = 50, 8, 4, 0.05
    tgrid = uniform_tgrid(n, device="cuda")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    L = cfg.num_layers
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
    want = {"fused_step_rectify_accept": rounds, "fused_step_rectify": 0,
            "rmsnorm": (2 * L + 1) * rounds, "flash_attention": L * rounds}
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
    rounds = static.total_rounds()
    want = {"fused_step_rectify_accept": 0, "fused_step_rectify": rounds,
            "rmsnorm": (2 * L + 1) * rounds, "flash_attention": L * rounds}
    if c2 != want or static.executor.kernel_path != "fused-accept-cuda":
        raise AssertionError(f"ChordsEngine launches {c2} != {want}")
    out["static"] = dict(requests=4, rounds=rounds, wall_s=wall,
                         s_per_round=wall / rounds, launches=c2,
                         rounds_used=[o.rounds_used for _, o in done2])
    emit("serve", layers=L, **out)
    profile_rounds(drift, tgrid, n, k, s)
    return {name: c1[name] + c2[name] for name in c1}


def profile_rounds(drift, tgrid, n, k, s, rounds: int = 3):
    """Where a serving round's time goes, on a full grid after one warm
    step (rtol 0: no lane drains), ``rounds`` steps timed without the
    profiler (wall per round),
    then ``rounds`` steps under ``torch.profiler`` (device time by kernel).
    The idle share is 1 - device time / unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ContinuousEngine, Request
    engine = ContinuousEngine(drift, (1, 64, 16), n, k, tgrid, num_slots=s,
                              rtol=0.0, use_kernel=True, device="cuda")
    for i in range(s):
        engine.submit(Request(rid=i, seed=300 + i))
    with torch.no_grad():
        engine.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / rounds
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                engine.step()
            torch.cuda.synchronize()
    # kernels are CUDA-typed events; the engine's "dispatch/round" range
    # also shows on the device timeline and would count every kernel twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("dispatch/")]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / rounds
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    ours = {}
    for e in events:
        for tag in ("step_rectify", "row_sum", "rmsnorm_kernel",
                    "flash_fwd_kernel"):
            if tag in e.key:
                ours[tag] = {"launches_per_round": e.count / rounds,
                             "device_ms_per_launch":
                                 e.self_device_time_total / 1e3 / e.count}
    emit("profile", rounds=rounds, wall_ms_per_round=wall * 1e3,
         device_ms_per_round=busy,
         device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
         port_kernels=ours,
         top=[{"name": e.key[:80], "calls_per_round": e.count / rounds,
               "ms_per_round": e.self_device_time_total / 1e3 / rounds}
              for e in top])


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
}


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
    if "drift" in phases or "serve" in phases:
        cfg, params = build_model()
        if "drift" in phases:
            phase_drift(cfg, params)
        if "serve" in phases:
            launches = phase_serve(cfg, params)
        del params
    missing = [n for n, c in launches.items() if c == 0]
    if "serve" in phases and missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
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
