"""What the host costs a serving round on one card, and whether it can run
ahead of the device: the measurements behind the overlap engine's finding.

    python3 benchmarks/torch_host_enqueue.py

1. The launch queue: how many kernel launches the host can enqueue
   behind a busy device before a launch blocks. The device is held by one
   ~0.2 s sleep kernel, then N one-element ``add_`` launches are timed on
   the host; a host time near the sleep's length means the queue filled.
2. The serving round: ``chords-dit-xl`` at full width and depth (random
   weights from seed 0, bf16, the kernels on; latent (1, 64, 16),
   K=8, S=4, a full grid at rtol 0) enqueued by the host (a) with the
   device idle (synchronize before each round), (b) behind a ~0.2 s sleep
   kernel (and its wall time from the sleep's end until the device has
   run it: the round with the host ahead as far as the queue lets it), and
   (c) back to back as the overlap engine's fast path issues them
   (``ContinuousEngine(overlap=True).step()``, no readback), beside the
   synchronous engine's steps; with the device time and the kernel
   launches of one round from a profiler window, and the round captured
   once as a CUDA graph and replayed (device time per replay). Every
   engine here runs the eager programs (``RoundExecutor(eager=True)``):
   this measures the per-launch host cost that the engines' CUDA graphs
   (``serve/graphs.py``, the default on the card) remove.

One JSON line per measurement, the card's name and power limit first.
Times are medians of 10 (host clock; ``torch.cuda.synchronize`` closes
each window where the device's completion is part of the time).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SLEEP_CYCLES = 400_000_000  # ~0.2 s at the H100's ~1.98 GHz


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _timed(fn, before=None, reps: int = 10):
    """Median host seconds of ``fn()`` (``before()`` untimed each time)."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return _median(out)


def _sleep():
    import torch
    torch.cuda._sleep(SLEEP_CYCLES)


def launch_queue():
    import torch
    x = torch.zeros(1, device="cuda")
    sleep_s = _timed(lambda: (_sleep(), torch.cuda.synchronize()))
    print(json.dumps({"measure": "sleep kernel", "seconds": sleep_s}),
          flush=True)
    for n in (256, 512, 1024, 2048, 4096):
        def burst(n=n):
            for _ in range(n):
                x.add_(1.0)
        host_idle = _timed(burst)
        host_behind = _timed(burst, before=_sleep)
        print(json.dumps({"measure": "launches behind a busy device",
                          "launches": n, "host_s_device_idle": host_idle,
                          "host_s_behind_sleep": host_behind,
                          "blocked": host_behind > 0.5 * sleep_s}),
              flush=True)


def _graph_replay_s(fn, reps: int = 10) -> float:
    """Device seconds of ``fn``'s kernels replayed as one CUDA graph (CUDA
    events around ``reps`` replays): the round without its per-launch
    costs, the counterpart of the reference's jitted round."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / reps


def serving_round():
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, ROOT)
    from chip_smoke import build_model
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.serve import ContinuousEngine, Request
    from repro_torch.serve.executor import RoundExecutor
    cfg, params = build_model("chords-dit-xl")
    drift = make_drift(params, cfg.replace(use_kernels=True))
    n, k, s = 50, 8, 4
    tgrid = uniform_tgrid(n, device="cuda")

    def engine(overlap):
        ex = RoundExecutor(drift, tgrid, n, use_kernel=True, eager=True)
        e = ContinuousEngine(drift, (1, 64, 16), n, k, tgrid, num_slots=s,
                             rtol=0.0, overlap=overlap, executor=ex,
                             device="cuda")
        for i in range(s):
            e.submit(Request(rid=i, seed=300 + i))
        e.step()  # admit + first round
        return e

    with torch.no_grad():
        eng = engine(False)
        prog, st = eng._prog, eng.state

        def enqueue():
            prog.round(st)

        enqueue()
        sleep_s = _timed(lambda: (_sleep(), torch.cuda.synchronize()))
        rec = {"measure": "round enqueue",
               "host_s_device_idle": _timed(enqueue),
               "host_s_behind_sleep": _timed(enqueue, before=_sleep),
               # the round's wall time once the queue was filled behind
               # the sleep: device-bound, whatever the host's pace
               "wall_s_behind_sleep": _timed(
                   lambda: (enqueue(), torch.cuda.synchronize()),
                   before=_sleep) - sleep_s,
               "graph_replay_s": _graph_replay_s(enqueue)}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enqueue()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        rec["device_s"] = sum(e.self_device_time_total for e in ev) / 1e6
        rec["kernel_launches"] = sum(e.count for e in ev)
        print(json.dumps(rec), flush=True)
        for overlap in (False, True):
            e = engine(overlap)
            steps, t0 = 10, time.perf_counter()
            for _ in range(steps):
                e.step()
            host = (time.perf_counter() - t0) / steps
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
            print(json.dumps({"measure": "engine steps", "overlap": overlap,
                              "steps": steps, "host_s_per_step": host,
                              "wall_s_per_step": wall,
                              "host_syncs": e.host_syncs}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_host_enqueue: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    launch_queue()
    serving_round()
    return 0


if __name__ == "__main__":
    sys.exit(main())
