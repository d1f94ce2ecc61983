"""Host time a call of each kernel wrapper, and device time a call, at the
served shapes (PERF.md §6 rows 1, 2, 3, 3″, 4, 4⁶, 5 and 6), for comparing
two trees of the port in one call on one card.

    python3 benchmarks/torch_wrapper_host.py [--repo DIR] [--tag NAME]

``--repo`` is the tree whose ``src/repro_torch`` is imported (default:
this one), so the same script times a parent checkout unpacked beside it;
run the trees in turns (parent, change, change, parent). Per wrapper one
JSON line: host µs a call (median of 7 runs of 200 back-to-back calls,
each run ended by a synchronize, as ``torch_kernel_ablation.host_us``) and
device ms a call (CUDA events around 200 back-to-back calls, median of 5).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def host_us(fn, n: int = 200, reps: int = 7) -> float:
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


def device_ms(fn, n: int = 200, reps: int = 5) -> float:
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def wrappers(gen):
    """(name, shape, call) of each wrapper at its served shape."""
    import torch
    from repro_torch.kernels.device_loop.kernel import loop_step
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.rectify.kernel import (fused_step_rectify,
                                                    fused_step_rectify_accept)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk

    def r(*s, dt=torch.float32):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    lat = [r(32, 1024) for _ in range(6)]
    prev, sc = r(4, 1024), torch.rand(32, generator=gen, device="cuda")
    fire = sc < 0.5
    bf = torch.bfloat16
    x, w, xd, wd = r(2048, 3072, dt=bf), r(3072, dt=bf), r(4, 2560, dt=bf), \
        r(2560, dt=bf)
    q, k, v = (r(32, 64, 24, 128, dt=bf) for _ in range(3))
    lq, lk, lv = r(4, 512, 16, 128, dt=bf), r(4, 512, 8, 128, dt=bf), \
        r(4, 512, 8, 128, dt=bf)
    c, b = r(32, 64, 64), r(32, 64, 64)
    xdt = r(32, 80, 64, 64)
    cum = -torch.rand(32, 80, 64, generator=gen, device="cuda").cumsum(-1)
    live = torch.ones(4, dtype=torch.bool, device="cuda")
    done, d0 = torch.zeros_like(live), torch.zeros_like(live)
    ctrl = torch.tensor([1 << 30, 0, 0, 0], dtype=torch.int32, device="cuda")
    return [
        ("fused_step_rectify", [32, 1024],
         lambda: fused_step_rectify(*lat, sc, sc, fire)),
        ("fused_step_rectify_accept", [32, 1024, 4],
         lambda: fused_step_rectify_accept(*lat, prev, sc, sc, fire)),
        ("rmsnorm", [2048, 3072], lambda: rmsnorm(x, w)),
        ("rmsnorm", [4, 2560], lambda: rmsnorm(xd, wd)),
        ("flash_attention", [32, 64, 24, 128],
         lambda: flash_attention(q, k, v, causal=False)),
        ("flash_attention", [4, 512, 16, 8, 128],
         lambda: flash_attention(lq, lk, lv, causal=True)),
        ("ssd_chunk", [32, 80, 64, 64, 64],
         lambda: ssd_chunk(c, b, xdt, cum)),
        ("device_loop", [4], lambda: loop_step(live, done, d0, ctrl, 1)),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_wrapper_host: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.repo), "src"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    from repro_torch.kernels import build
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, fn in wrappers(gen):
        print(json.dumps({"tag": args.tag, "card": card, "kernel": name,
                          "shape": shape, "host_us": host_us(fn),
                          "device_ms": device_ms(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
