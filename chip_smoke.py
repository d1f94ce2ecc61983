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
              published peaks); flash over every case at every compiled
              head dim through both routes (bf16: the tensor-core kernel,
              f32: the CUDA-core kernel), ``ssd_chunk`` also at H 1, 3
              and 80 with Lc 1, 64, 100 and 256;
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
              the counters predict), and one
              profiled ``ChordsEngine`` batch gives the device time of its
              rectify kernel;
7. ssd      — one ``zamba2-2.7b`` Mamba2 layer at full width (d_model
              2560), f32, B=2, 512 tokens (two chunks of 256, so the
              inter-chunk recurrence runs on the card): the kernel
              arrangement against the plain scan body;
8. hybrid-drift — ``zamba2-2.7b`` at full width and all 54 layers, random
              bf16 weights from a seeded generator: ``denoise`` with the
              kernels against the plain versions on a [32, 64, 16] batch
              (relative L2 error), exact launch counts per call; and an f32
              check at full width and 6 layers (one group);
9. hybrid-serve — phase 6 with the hybrid drift (launch counts of all five
              kernels, profile).

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
PHASES = ("device", "build", "kernels", "parity", "drift", "serve", "ssd",
          "hybrid-drift", "hybrid-serve")

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


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).norm() / b.norm()))


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
    emit("kernels/flash_attention", cases=cases, f32_route=f32,
         hybrid_shape=hybrid)


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


def phase_kernels(records):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_rectify(gen, records)
    check_rmsnorm(gen, records)
    check_flash(gen, records)
    check_ssd(gen, records)
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
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


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
    want = {"fused_step_rectify_accept": rounds, "fused_step_rectify": 0,
            **{name: c * rounds for name, c in per_call.items()}}
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
            **{name: c * rounds for name, c in per_call.items()}}
    if c2 != want or static.executor.kernel_path != "fused-accept-cuda":
        raise AssertionError(f"ChordsEngine launches {c2} != {want}")
    out["static"] = dict(requests=4, rounds=rounds, wall_s=wall,
                         s_per_round=wall / rounds, launches=c2,
                         rounds_used=[o.rounds_used for _, o in done2])
    emit(phase, arch=cfg.name, layers=cfg.num_layers, **out)
    profile_rounds(drift, tgrid, n, k, s, phase + "/profile", per_call)
    if cfg.family == "dense":
        profile_static(drift, tgrid, n, k, s)
    return {name: c1[name] + c2[name] for name in c1}


# kernel-name substrings of the port's kernels in profiler keys
PORT_KERNEL_TAGS = ("step_rectify_kernel", "step_rectify_accept_kernel",
                    "row_sum", "rmsnorm_kernel", "flash_fwd_kernel",
                    "flash_fwd_mma_kernel", "ssd_chunk_kernel")


def _device_events(prof):
    import torch
    # kernels are CUDA-typed events; the engine's "dispatch/round" range
    # also shows on the device timeline and would count every kernel twice
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("dispatch/")]


# the kernel behind each wrapper on the bf16 serving paths
SERVE_TAGS = {"rmsnorm": "rmsnorm_kernel",
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


def profile_rounds(drift, tgrid, n, k, s, phase, per_call,
                   rounds: int = 3):
    """Where a serving round's time goes, on a full grid after one warm
    step (rtol 0: no lane drains), ``rounds`` steps timed without the
    profiler (wall per round),
    then ``rounds`` steps under ``torch.profiler`` (device time by kernel;
    each backbone kernel's launches per round must equal ``per_call``, one
    drift call a round). The idle share is 1 - device time / unprofiled
    wall time."""
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
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / rounds
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    ours = _port_kernels(events, rounds)
    emit(phase, rounds=rounds, wall_ms_per_round=wall * 1e3,
         device_ms_per_round=busy,
         device_idle_share=max(0.0, 1.0 - busy / (wall * 1e3)),
         port_kernels=ours,
         top=[{"name": e.key[:80], "calls_per_round": e.count / rounds,
               "ms_per_round": e.self_device_time_total / 1e3 / rounds}
              for e in top])
    _check_profiled_launches(ours, per_call)


def profile_static(drift, tgrid, n, k, s):
    """One ``ChordsEngine`` batch (s requests) under ``torch.profiler``:
    the device time per launch of its rectify kernel, which the
    ``ContinuousEngine`` profile never runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ChordsEngine, Request
    static = ChordsEngine(drift, (64, 16), n, k, tgrid, max_batch=s,
                          rtol=0.05, use_kernel=True, device="cuda")
    for i in range(s):
        static.submit(Request(rid=i, seed=400 + i))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        static.step()
        torch.cuda.synchronize()
    rounds = static.total_rounds()
    emit("serve/profile-static", rounds=rounds,
         port_kernels=_port_kernels(_device_events(prof), rounds))


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
    "ssd_chunk": ("src/repro_torch/csrc/ssd_scan.cu",
                  "src/repro/kernels/ssd_scan/kernel.py:63"),
}
# the kernels each serving path runs (the hybrid's adds ssd_chunk)
SERVE_KERNELS = {"serve": set(SOURCES) - {"ssd_chunk"},
                 "hybrid-serve": set(SOURCES)}


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
    for arch, drift_phase, serve_phase in (
            ("chords-dit-xl", "drift", "serve"),
            ("zamba2-2.7b", "hybrid-drift", "hybrid-serve")):
        if arch == "zamba2-2.7b" and "ssd" in phases:
            phase_ssd()
        if drift_phase not in phases and serve_phase not in phases:
            continue
        torch.cuda.reset_peak_memory_stats()
        cfg, params = build_model(arch)
        if drift_phase in phases:
            phase_drift(cfg, params, drift_phase)
        if serve_phase in phases:
            counts = phase_serve(cfg, params, serve_phase)
            missing = [n for n in SERVE_KERNELS[serve_phase] if not counts[n]]
            if missing:
                raise AssertionError(f"kernels never launched on the "
                                     f"{serve_phase} path: {missing}")
            launches = {n: launches[n] + counts[n] for n in launches}
        del cfg, params
        torch.cuda.empty_cache()
        if drift_phase == "hybrid-drift" and drift_phase in phases:
            phase_hybrid_f32()
            torch.cuda.empty_cache()
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
