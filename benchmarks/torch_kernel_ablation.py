"""Ablations of the port's redesigned CUDA kernels on one card: what bounds
them.

    python3 benchmarks/torch_kernel_ablation.py [ssd,flash,rmsnorm,profiler,profiler-serve,step,accept,host]

``ssd_chunk``: copies of ``src/repro_torch/csrc/ssd_scan.cu`` with one part
of the kernel cut out by a text substitution (each cut is asserted to
match, so a stale pattern fails loudly) are built with ``nvcc`` into
``build/ablation/`` and launched through the C interface, at the serving
shape and a full 256-row chunk. The time a cut saves is what that part
costs where it does not overlap the rest. Only the uncut kernel's outputs
mean anything; they are held against the plain version (bitwise flag and
max abs error). Beside them, the time PyTorch's own fill and copy kernels
take for the same output writes and input reads, a floor the card reaches
for this traffic. ``flash_attention``: both routes (bf16 tensor cores, f32
CUDA cores) at the two serving shapes, beside SDPA.

``rmsnorm``, ``fused_step_rectify`` (section ``step``) and
``fused_step_rectify_accept``: the launchers take any valid launch plan,
so the alternatives to the wrappers' own plans are launched through the C
interface and timed by device time (a profiler window) at the serving
shapes, beside ``F.rms_norm``; every launch is held against the plain
version. ``profiler``: how many kernel records a profiler window keeps,
with and without host gaps at its edges, beside a CUDA graph's count;
``profiler-serve`` (run only when named): the same before and after
``chip_smoke``'s serve phase, with and without its primer. ``host``: what the host spends per call on each
step of the three wrappers and on ``F.rms_norm`` (wall time of 200 calls,
the device never the slower side).

Times of the ssd and flash sections are device times: CUDA events around
back-to-back launches through ctypes (the loop issues faster than the
kernels run), median of 7 runs of 50. One JSON line per measurement; the
card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "ssd_scan.cu")
OUT = os.path.join(ROOT, "build", "ablation")
RMSNORM_SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "rmsnorm.cu")
# the rows-in-registers kernel without its register cap
RMSNORM_CUTS = {"no register cap": [("constexpr int kMinBlocks = 6;",
                                     "constexpr int kMinBlocks = 1;")]}

# name -> [(text in ssd_scan.cu, replacement), ...]. A store is cut with a
# guard that is false at run time (lc < 0), so that the compiler cannot
# drop the products that feed it as dead code.
CUTS = {
    "no products": [
        ("        mm4x4<kT, HD>(y_acc,", "        if (lc < 0) mm4x4<kT, HD>(y_acc,"),
        ("        if (last)\n          mm4x4<HD, N>(s_acc,",
         "        if (last && lc < 0)\n          mm4x4<HD, N>(s_acc,")],
    "no output stores": [
        ("          if (l < lc)\n", "          if (l < lc && lc < 0)\n"),
        ("      if (last && r0 < HD && c0 < N)\n",
         "      if (last && r0 < HD && c0 < N && lc < 0)\n")],
    "no exp in P": [("expf(cumh[lg] - cumh[mg])", "1.0f")],
}


def _variants(src=SRC, cuts=None):
    src_text = open(src).read()
    out = {"kernel": src_text}
    for name, subs in (CUTS if cuts is None else cuts).items():
        text = src_text
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"ablation '{name}': {old!r} does not occur "
                                 f"exactly once in {src}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(variants, stem="ssd"):
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        cu = os.path.join(OUT, f"{stem}_{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"{stem}_{i}.so")
        procs[name] = (so, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for '{name}':\n{log}")
        libs[name] = so
    return libs


def events_ms(fn, reps: int = 50, iters: int = 7) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def ablate_ssd(libs, gen, stream):
    import torch
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref
    for shape in ((32, 80, 64, 64, 64), (4, 80, 256, 64, 64)):
        g, h, lc, n, hd = shape
        c, b = (torch.randn(g, lc, n, generator=gen, device="cuda")
                for _ in range(2))
        x = torch.randn(g, h, lc, hd, generator=gen, device="cuda")
        cum = -torch.randn(g, h, lc, generator=gen, device="cuda").abs() \
            .cumsum(-1)
        ry, rs = ssd_chunk_batched_ref(c, b, x, cum)
        # what the card takes for the kernel's own traffic alone: writing
        # y and s, and reading xdt while writing y and s
        y0, s0 = torch.empty_like(ry), torch.empty_like(rs)
        floors = {
            "write y and s (zero_)": lambda: (y0.zero_(), s0.zero_()),
            "read xdt, write y and s (copy_)": lambda: (
                y0.copy_(x), s0.copy_(x[:, :, :hd, :n])),
        }
        for name, fn in floors.items():
            print(json.dumps({"kernel": "ssd_chunk", "variant": name,
                              "shape": list(shape),
                              "device_ms": events_ms(fn)}), flush=True)
        # every cut launches with the kernel's own launch description
        meta = SK.launch_meta(g, h, lc, n, hd,
                              *SK.device_slots(0, n, hd, lc))
        for name, so in libs.items():
            fn = ctypes.CDLL(so).ssd_chunk_fwd
            fn.argtypes = SK._lib().ssd_chunk_fwd.argtypes
            y = torch.empty_like(x)
            s = torch.empty(g, h, hd, n, device="cuda")
            args = [ctypes.c_void_p(t.data_ptr())
                    for t in (c, b, x, cum, y, s)] + [
                g, h, lc, n, hd, SK.head_group(meta), meta.grid[0],
                meta.dynamic_smem, stream]
            if fn(*args) != 0:
                raise SystemExit(f"launch of '{name}' failed")
            torch.cuda.synchronize()
            rec = {"kernel": "ssd_chunk", "variant": name, "shape": list(shape),
                   "device_ms": events_ms(lambda: fn(*args))}
            if name == "kernel":
                rec["bitwise"] = bool(torch.equal(y, ry) and torch.equal(s, rs))
                rec["max_abs_err"] = max(float((y - ry).abs().max()),
                                         float((s - rs).abs().max()))
            print(json.dumps(rec), flush=True)


def flash_routes(gen, stream):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref
    lib = K._lib()
    for b, s, h, dh, causal in ((32, 64, 24, 128, False),
                                (32, 64, 32, 80, True)):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
                       .to(dt) for _ in range(3))
            o = torch.empty_like(q)
            meta = K.launch_meta(dt, dh, b, s, s, h, h, causal)
            args = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o)] + \
                [b, s, s, h, h, dh, dh ** -0.5, int(causal),
                 K.DTYPE_CODES[dt], meta.grid[0], meta.threads,
                 meta.dynamic_smem, stream]
            ms = events_ms(lambda: lib.flash_attention_fwd(*args))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = events_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
            err = float((o.float() - attention_ref(q, k, v, causal).float())
                        .abs().max())
            print(json.dumps({"kernel": "flash_attention",
                              "shape": [b, s, h, dh], "causal": causal,
                              "dtype": str(dt).replace("torch.", ""),
                              "device_ms": ms, "sdpa_ms": sdpa,
                              "max_abs_err": err}), flush=True)


def profiled_ms(fn, calls: int = 50):
    """Device time per launch of ``fn`` (all kernels it launches) from a
    ``torch.profiler`` window with host gaps at both ends (see
    :func:`profiler_windows`), and the kernel launches per call."""
    import torch
    prof = _window(fn, calls, GAP_S)
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.key.startswith("ProfilerStep")]
    n = sum(e.count for e in ev)
    return (sum(e.self_device_time_total for e in ev) / 1e3 / max(1, n),
            n / calls)


# host seconds between a profiler window's edges and its device work, as
# chip_smoke.GAP_S (see profiler_windows)
GAP_S = 0.005


def _window(fn, calls: int, gap_s: float):
    """A ``torch.profiler`` window over ``calls`` calls of ``fn``, after a
    warm-up window of as many calls; with ``gap_s``, the host waits that
    long after the window opens and after the device drained, before it
    closes."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(gap_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(gap_s)
    return prof


def profiler_windows(gen, windows: int = 30, calls: int = 20):
    """How many launches a ``torch.profiler`` window records, without and
    with host gaps at its edges, for the step and the accept wrapper and a
    library kernel of the same size (``torch.add``), at [32, 1024]. Each
    recorded kernel is matched to its launch's runtime record by
    correlation id: a launch without a kernel is a lost record, and its
    position in the window (0 = first call) says where the loss is; a
    kernel stamped before its own launch shows the device clock reading
    behind the host's, which is what drops a kernel that ran just after
    the window opened. The kernels a call enqueues are also counted from
    a captured CUDA graph."""
    import torch
    from chip_smoke import graph_kernel_nodes
    from repro_torch.kernels.rectify import kernel as K
    rows, m = 32, 1024
    lat = [torch.randn(rows, m, generator=gen, device="cuda")
           for _ in range(6)]
    prev = torch.randn(4, m, generator=gen, device="cuda")
    dt, ds = (torch.rand(rows, generator=gen, device="cuda") for _ in "ab")
    fire = torch.rand(rows, generator=gen, device="cuda") < 0.5
    sink = torch.empty_like(lat[0])
    fns = {"step": lambda: K.fused_step_rectify(*lat, dt, ds, fire),
           "accept": lambda: K.fused_step_rectify_accept(*lat, prev, dt, ds,
                                                         fire),
           "torch.add": lambda: torch.add(lat[0], lat[1], out=sink)}
    for name, fn in fns.items():
        print(json.dumps({"profiler": name, "graph_kernel_nodes":
                          graph_kernel_nodes(fn)}), flush=True)
    for gap in (0.0, GAP_S):
        for name, fn in fns.items():
            recorded, lost_at, skew, early, margin = [], [], [], [], []
            for _ in range(windows):
                res = _window(fn, calls, gap).profiler.kineto_results
                evs = [e for e in res.events()
                       if not e.name().startswith("ProfilerStep")]
                dev = {}
                for e in evs:
                    if e.device_type() == torch.autograd.DeviceType.CUDA:
                        dev[e.correlation_id()] = dev[
                            e.linked_correlation_id()] = e
                api = sorted((e for e in evs if e.name().startswith(
                    "cudaLaunchKernel")), key=lambda e: e.start_ns())
                recorded.append(sum(
                    e.device_type() == torch.autograd.DeviceType.CUDA
                    for e in evs))
                for i, e in enumerate(api):
                    k = dev.get(e.correlation_id())
                    if k is None:
                        lost_at.append(i)
                        continue
                    skew.append((k.start_ns() - e.start_ns()) / 1e3)
                    if k.start_ns() < e.start_ns():
                        early.append(i)
                    margin.append((k.start_ns() - res.trace_start_ns()) / 1e3)
            skew.sort()
            print(json.dumps({
                "profiler": name, "gap_s": gap, "windows": windows,
                "calls": calls, "launch_records_per_window": len(api),
                "kernels_recorded_min": min(recorded),
                "kernels_recorded_mean": sum(recorded) / windows,
                "windows_with_loss": sum(r < calls for r in recorded),
                "lost_at_call": sorted(set(lost_at)),
                "lost_total": len(lost_at),
                "kernel_minus_launch_us": {
                    "min": skew[0] if skew else None,
                    "median": skew[len(skew) // 2] if skew else None},
                # kernels stamped before their own launch: the device
                # clock read behind the host's, and at which calls
                "kernels_before_launch": len(early),
                "before_launch_at_call": sorted(set(early)),
                "kernel_after_window_start_us_min":
                    min(margin) if margin else None}),
                flush=True)


def _body_losses(prof, skip: int):
    """The launches of a window's body (its launch records after the first
    ``skip``, a primer's) whose kernel record the profiler lost, by
    position in the body (0 = first call), matched by correlation id."""
    import torch
    evs = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = set()
    for e in evs:
        if e.device_type() == cuda:
            dev.update((e.correlation_id(), e.linked_correlation_id()))
    api = sorted((e for e in evs if e.device_type() != cuda
                  and e.name().startswith(("cudaLaunch", "cuLaunch"))),
                 key=lambda e: e.start_ns())[skip:]
    return len(api), [i for i, e in enumerate(api)
                      if e.correlation_id() not in dev]


def profiler_after_serve(windows: int = 6, calls: int = 20):
    """How many kernel records a ``torch.profiler`` window keeps before and
    after ``chip_smoke``'s serve phase (``chords-dit-xl`` at full width:
    the continuous engine, the stream graph, the profiled rounds and
    one-kernel checks), for the accept wrapper and ``torch.add`` at
    [32, 1024]. Four windows: ``plain`` (opened, ``GAP_S``, the body,
    synchronize, ``GAP_S``), ``schedule`` (the body first in a warm-up
    window, as ``chip_smoke.profiled`` did without a primer), and each of
    them opening with ``chip_smoke``'s primer launches. A launch of the
    body without a kernel record is lost, at its position in the body.
    Exit code 1 if the serve phase failed."""
    import time
    import torch
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels.rectify.ops import step_rectify_accept
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = torch.Generator(device="cuda").manual_seed(6)
    lat, prev, dt, ds, fire = cs._rectify_operands(32, 1024, 4, gen)
    sink = torch.empty_like(lat[0])
    fns = {"accept": lambda: step_rectify_accept(*lat, prev, dt, ds, fire,
                                                 use_kernel=True),
           "torch.add": lambda: torch.add(lat[0], lat[1], out=sink)}

    def window(fn, sched: bool, prime: bool):
        def body():
            for _ in range(calls):
                fn()
        kw = {"schedule": schedule(wait=0, warmup=1, active=1)} \
            if sched else {}
        with profile(activities=acts, **kw) as prof:
            if sched:
                body()
                torch.cuda.synchronize()
                prof.step()
            if prime:
                cs._prime()
            time.sleep(cs.GAP_S)
            body()
            torch.cuda.synchronize()
            time.sleep(cs.GAP_S)
        return _body_losses(prof, cs.PRIME_LAUNCHES if prime else 0)

    def survey(state):
        for name, fn in fns.items():
            for sched in (False, True):
                for prime in (False, True):
                    lost, launches = [], set()
                    for _ in range(windows):
                        n, at = window(fn, sched, prime)
                        launches.add(n)
                        lost.append(at)
                    print(json.dumps({
                        "profiler-serve": state, "fn": name,
                        "window": ("schedule" if sched else "plain")
                        + ("+primer" if prime else ""),
                        "windows": windows, "calls": calls,
                        "body_launch_records": sorted(launches),
                        "windows_with_loss": sum(bool(a) for a in lost),
                        "lost_at_call": sorted({i for a in lost for i in a}),
                        "lost_per_window": [len(a) for a in lost]}),
                        flush=True)

    cs.phase_device()
    cs.phase_build()
    survey("before serve")
    cfg, params = cs.build_model("chords-dit-xl")
    failed = None
    try:
        cs.phase_serve(cfg, params, "serve")
    except AssertionError as e:
        failed = str(e)
        print(json.dumps({"profiler-serve": "serve failed",
                          "error": failed[:800]}), flush=True)
    survey("after serve")
    return 1 if failed else 0


def host_us(fn, n: int = 200, reps: int = 7) -> float:
    """Host wall time per call, median of ``reps`` runs of ``n`` calls."""
    import time
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def rmsnorm_plans(gen):
    """Every launch plan of the rows-in-registers kernel with 16-byte loads
    (threads a row x rows a block), with and without its register cap, and
    the two sweeps, at the served widths, beside ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import kernel as K
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    fns = {}
    for name, so in _build(_variants(RMSNORM_SRC, RMSNORM_CUTS),
                           "rmsnorm").items():
        fn = ctypes.CDLL(so).rmsnorm_fwd
        fn.argtypes = K._fwd().argtypes
        fns[name] = fn
    stream = build.stream_handle(0)
    for rows, d in ((2048, 3072), (2048, 2560), (2048, 5120)):
        x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        ref = rmsnorm_ref(x, w)
        y = torch.empty_like(x)
        plans = {"two sweeps": K.Plan(K.TWO_SWEEPS, 8, 256, 0, 1)}
        for tpr in range(32, 257, 32):
            nv = -(-(d // 8) // tpr)
            for g in (1, 2, 4, 8):
                if nv <= K.MAX_VECS and tpr * g <= K.BLOCK_THREADS:
                    plans[f"rows {tpr}x{g}"] = K.Plan(K.ROWS_IN_REGISTERS, 8,
                                                      tpr, nv, g)
        chosen = K.plan(d, torch.bfloat16, True)
        for lib, fn in fns.items():
            for name, p in plans.items():
                if lib != "kernel" and p.variant != K.ROWS_IN_REGISTERS:
                    continue
                grid_x = rows if p.variant == K.TWO_SWEEPS else \
                    -(-rows // p.rows_per_block)
                smem = 0 if p.variant == K.TWO_SWEEPS else 2 * d
                args = [x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d,
                        1e-6, K.pack_config(1, 1, p), grid_x, smem, stream]
                y.zero_()
                if fn(*args):
                    raise SystemExit(f"rmsnorm plan {name} failed to launch")
                ms, _ = profiled_ms(lambda: fn(*args))
                print(json.dumps({
                    "kernel": "rmsnorm", "build": lib, "shape": [rows, d],
                    "plan": name, "chosen": lib == "kernel" and p == chosen,
                    "device_ms": ms,
                    "max_abs_err": float((y.float() - ref.float()).abs()
                                         .max())}), flush=True)
        ms, n = profiled_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
        print(json.dumps({"kernel": "rmsnorm", "shape": [rows, d],
                          "plan": "F.rms_norm", "device_ms": ms,
                          "kernels_per_call": n}), flush=True)


def _accept_args(lat, prev, dt, ds, fire, out, sums, plan, stream):
    rows, m = lat[0].shape
    cluster, span, threads, vec = plan
    return [t.data_ptr() for t in (*lat, prev, dt, ds, fire, out, sums)] + [
        rows, m, rows // prev.shape[0], span,
        cluster | threads << 4 | vec << 16, rows * cluster, stream]


def step_plans(gen, rotations: int = 7):
    """The step kernel at the serving shape ([32, 1024]) through every
    block size and both load widths, the wrapper's own plan marked: each
    plan's device time per launch in ``rotations`` profiler windows, taken
    in turns with the other plans (median, min, max)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rectify import kernel as K
    from repro_torch.kernels.rectify.ref import fused_step_rectify_ref
    fn = K._step_fn()
    stream = build.stream_handle(0)
    rows, m = 32, 1024
    lat = [torch.randn(rows, m, generator=gen, device="cuda")
           for _ in range(6)]
    dt, ds = (torch.rand(rows, generator=gen, device="cuda") for _ in "ab")
    fire = torch.rand(rows, generator=gen, device="cuda") < 0.5
    ref = fused_step_rectify_ref(*lat, dt, ds, fire)
    out = torch.empty_like(ref)
    chosen = K.step_plan(rows, m, True)
    plans = [K.StepPlan(threads, vec) for vec in (4, 1)
             for threads in (32, 64, 128, 256)]
    args, bitwise, times, counts = {}, {}, {p: [] for p in plans}, set()
    for plan in plans:
        args[plan] = [t.data_ptr() for t in (*lat, dt, ds, fire, out)] + [
            rows, m, plan.word, rows * -(-m // (plan.threads * plan.vec)),
            stream]
        out.zero_()
        if fn(*args[plan]):
            raise SystemExit(f"step plan {plan} failed to launch")
        torch.cuda.synchronize()
        bitwise[plan] = bool(torch.equal(out, ref))
    for _ in range(rotations):  # the plans in turn, so drift hits them all
        for plan in plans:
            ms, n = profiled_ms(lambda: fn(*args[plan]))
            times[plan].append(ms)
            counts.add(n)
    for plan in plans:
        t = sorted(times[plan])
        print(json.dumps({
            "kernel": "fused_step_rectify", "shape": [rows, m],
            "plan": plan._asdict(), "chosen": plan == chosen,
            "blocks": rows * -(-m // (plan.threads * plan.vec)),
            "device_ms": t[len(t) // 2], "device_ms_min": t[0],
            "device_ms_max": t[-1], "windows": rotations,
            "kernels_per_call": sorted(counts),
            "out_bitwise": bitwise[plan]}), flush=True)


def accept_plans(gen):
    """The accept kernel at the serving shape ([32, 1024], prev [4, 1024])
    through every cluster size, load width and block size."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.rectify import kernel as K
    from repro_torch.kernels.rectify.ref import fused_step_rectify_accept_ref
    fn = K._accept_fn()
    stream = build.stream_handle(0)
    rows, m, p = 32, 1024, 4
    lat = [torch.randn(rows, m, generator=gen, device="cuda")
           for _ in range(6)]
    prev = torch.randn(p, m, generator=gen, device="cuda")
    dt, ds = (torch.rand(rows, generator=gen, device="cuda") for _ in "ab")
    fire = torch.rand(rows, generator=gen, device="cuda") < 0.5
    ro, re, rs = fused_step_rectify_accept_ref(*lat, prev, dt, ds, fire)
    out = torch.empty_like(ro)
    sums = torch.empty(2, rows, device="cuda")
    chosen = tuple(K.accept_plan(rows, m, True))
    for cluster in (1, 2, 4, 8):
        for vec in (4, 1):
            span = -(-m // (cluster * vec)) * vec
            for threads in (32, 64, 128, 256):
                if threads * vec > span and threads > 32:
                    continue
                plan = (cluster, span, threads, vec)
                args = _accept_args(lat, prev, dt, ds, fire, out, sums, plan,
                                    stream)
                if fn(*args):
                    raise SystemExit(f"accept plan {plan} failed to launch")
                ms, _ = profiled_ms(lambda: fn(*args))
                torch.cuda.synchronize()
                print(json.dumps({
                    "kernel": "fused_step_rectify_accept",
                    "shape": [rows, m, p], "plan": plan,
                    "chosen": plan == chosen, "device_ms": ms,
                    "out_bitwise": bool(torch.equal(out, ro)),
                    "sum_rel_err": float(((sums[0] - re).abs() / re).max())}),
                    flush=True)


def host_path(gen):
    """Host time per call of each step of the rmsnorm and accept wrappers,
    and of the whole wrappers beside ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.rectify import kernel as R
    from repro_torch.kernels.rmsnorm import kernel as K
    dev = torch.device("cuda", 0)
    rows, d = 2048, 3072
    x = torch.randn(rows, d, generator=gen, device="cuda").bfloat16()
    w = torch.ones(d, device="cuda").bfloat16()
    y = torch.empty_like(x)
    cfg, grid_x, smem = K._launch_args(rows, d, torch.bfloat16,
                                       torch.bfloat16, True)
    args = [x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, 1e-6, cfg,
            grid_x, smem, build.stream_handle(0)]
    bad = list(args)
    bad[6] = cfg | 3 << 2  # an invalid variant: returns before any launch
    lat = [torch.randn(32, 1024, generator=gen, device="cuda")
           for _ in range(6)]
    prev = torch.randn(4, 1024, generator=gen, device="cuda")
    sc = torch.rand(32, generator=gen, device="cuda")
    fire = sc < 0.5
    out, sums = torch.empty_like(lat[0]), torch.empty(2, 32, device="cuda")
    plan = R.accept_plan(32, 1024, True)
    aargs = _accept_args(lat, prev, sc, sc, fire, out, sums, plan,
                         build.stream_handle(0))
    abad = list(aargs)
    abad[-3] = 0  # cluster 0: returns before any launch
    word, grid_x = R._step_args(32, 1024, True)
    sargs = [t.data_ptr() for t in (*lat, sc, sc, fire, out)] + [
        32, 1024, word, grid_x, build.stream_handle(0)]
    sbad = list(sargs)
    sbad[-3] = 0  # threads 0: returns before any launch
    steps = {
        "F.rms_norm": lambda: F.rms_norm(x, (d,), w, 1e-6),
        "rmsnorm wrapper": lambda: K.rmsnorm(x, w),
        "rmsnorm C call (launch)": lambda: K._fwd()(*args),
        "rmsnorm C call (no launch, 10 arguments)": lambda: K._fwd()(*bad),
        "torch.empty_like": lambda: torch.empty_like(x),
        "x.new_empty": lambda: x.new_empty(x.shape),
        "torch.empty(shape, dtype, device)": lambda: torch.empty(
            x.shape, dtype=x.dtype, device=x.device),
        "build.stream_handle": lambda: build.stream_handle(0),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "launch arguments (cached)": lambda: K._launch_args(
            rows, d, torch.bfloat16, torch.bfloat16, True),
        "checks (device, dtype, shape, contiguity)": lambda: (
            x.is_cuda and w.is_cuda, w.get_device() != x.get_device(),
            x.dtype in K.DTYPE_CODES, w.dtype in K.DTYPE_CODES,
            w.shape != (d,), x.is_contiguous(), w.is_contiguous()),
        "data_ptr x3": lambda: (x.data_ptr(), w.data_ptr(), y.data_ptr()),
        "step wrapper": lambda: R.fused_step_rectify(*lat, sc, sc, fire),
        "step C call (launch)": lambda: R._step_fn()(*sargs),
        "step C call (no launch, 15 arguments)": lambda: R._step_fn()(*sbad),
        "step launch arguments (cached)": lambda: R._step_args(32, 1024,
                                                               True),
        "torch.empty_like (32, 1024)": lambda: torch.empty_like(lat[0]),
        "accept wrapper": lambda: R.fused_step_rectify_accept(
            *lat, prev, sc, sc, fire),
        "accept checks": lambda: R._check_operands(lat, (sc, sc), fire),
        "accept C call (launch)": lambda: R._accept_fn()(*aargs),
        "accept C call (no launch, 19 arguments)":
            lambda: R._accept_fn()(*abad),
        "accept_plan (cached)": lambda: R.accept_plan(32, 1024, True),
        "data_ptr x11": lambda: [t.data_ptr() for t in (*lat, prev, sc, sc,
                                                        fire)],
        "new_empty (2, rows)": lambda: lat[0].new_empty((2, 32)),
        "sums.unbind()": lambda: sums.unbind(),
        "sums[0], sums[1]": lambda: (sums[0], sums[1]),
    }
    for name, fn in steps.items():
        print(json.dumps({"host": name, "us_per_call": host_us(fn)}),
              flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sections = sys.argv[1].split(",") if len(sys.argv) > 1 else \
        ["ssd", "flash", "rmsnorm", "profiler", "step", "accept", "host"]
    if "ssd" in sections:
        ablate_ssd(_build(_variants()), gen, stream)
    if "flash" in sections:
        flash_routes(gen, stream)
    if "rmsnorm" in sections:
        rmsnorm_plans(gen)
    if "profiler" in sections:
        profiler_windows(gen)
    rc = 0
    if "profiler-serve" in sections:
        rc = profiler_after_serve()
    if "step" in sections:
        step_plans(gen)
    if "accept" in sections:
        accept_plans(gen)
    if "host" in sections:
        host_path(gen)
    return rc


if __name__ == "__main__":
    sys.exit(main())
