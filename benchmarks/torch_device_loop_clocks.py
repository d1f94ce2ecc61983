"""Why a ``chords-dit-xl`` round runs slower at R=8 than at R=1 on the
graphs: the SM clock, board power and the driver's clock-limit reasons
through long steady serving windows, beside each window's time a round.

    python3 benchmarks/torch_device_loop_clocks.py [--arch chords-dit-xl]
        [--passes 2] [--rounds 240]

Each window serves a full grid at the launcher's widths (random weights
from seed 0, bf16, the kernels on; latent (1, 64, 16), K=8, S=4) on the
CUDA graphs at rtol 0 with N=400, so no lane drains inside ``--rounds``
rounds: the synchronous loop at R=1 (round-graph replays, a readback
each) and R=8 (``multi`` loop graphs; device time from the loop's own
clock), and the overlap loop at R=1 and R=8 (``roll``: round-graph
replays, no readback). The four windows run in one order, then in the
reverse, ``--passes`` times in all (A B C D D C B A ...), so a drift of
the card's state over the run shows as a difference between passes. A
thread samples NVML every 10 ms (SM clock, power, temperature and the
clock-limit reasons); each window reports the means of its samples.

One JSON line per window, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N, K, S = 400, 8, 4
# NVML clock-limit reason bits (nvmlClocksEventReasons)
REASONS = {0x4: "sw_power_cap", 0x8: "hw_slowdown",
           0x20: "sw_thermal", 0x40: "hw_thermal", 0x80: "hw_power_brake"}


class Sampler(threading.Thread):
    """NVML samples of device 0 every ``period`` s: (host time, SM MHz,
    power W, temperature C, clock-limit reason bits)."""

    def __init__(self, period: float = 0.01):
        super().__init__(daemon=True)
        self.period = period
        self.samples = []
        self._stop_evt = threading.Event()
        self.nvml = ctypes.CDLL("libnvidia-ml.so.1")
        if self.nvml.nvmlInit_v2():
            raise RuntimeError("nvmlInit failed")
        self.handle = ctypes.c_void_p()
        if self.nvml.nvmlDeviceGetHandleByIndex_v2(
                0, ctypes.byref(self.handle)):
            raise RuntimeError("nvmlDeviceGetHandleByIndex failed")
        self._reasons = getattr(
            self.nvml, "nvmlDeviceGetCurrentClocksEventReasons", None) \
            or self.nvml.nvmlDeviceGetCurrentClocksThrottleReasons

    def run(self):
        nv, h = self.nvml, self.handle
        clock, power, temp = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
        reasons = ctypes.c_ulonglong()
        while not self._stop_evt.is_set():
            nv.nvmlDeviceGetClockInfo(h, 1, ctypes.byref(clock))  # SM
            nv.nvmlDeviceGetPowerUsage(h, ctypes.byref(power))  # mW
            nv.nvmlDeviceGetTemperature(h, 0, ctypes.byref(temp))
            self._reasons(h, ctypes.byref(reasons))
            self.samples.append((time.time(), clock.value,
                                 power.value / 1e3, temp.value,
                                 reasons.value))
            time.sleep(self.period)

    def stop(self):
        self._stop_evt.set()
        self.join()
        self.nvml.nvmlShutdown()

    def between(self, t0: float, t1: float) -> dict:
        got = [s for s in self.samples if t0 <= s[0] <= t1]
        if not got:
            return {"samples": 0}
        n = len(got)
        return {"samples": n,
                "sm_mhz_mean": sum(s[1] for s in got) / n,
                "sm_mhz_min": min(s[1] for s in got),
                "sm_mhz_max": max(s[1] for s in got),
                "power_w_mean": sum(s[2] for s in got) / n,
                "temp_c_mean": sum(s[3] for s in got) / n,
                "reason_share": {name: sum(bool(s[4] & bit) for s in got) / n
                                 for bit, name in REASONS.items()}}


def window(drift, tgrid, overlap: bool, r_dev: int, rounds: int,
           sampler: Sampler) -> dict:
    import torch
    from chip_smoke import _engine, _stats
    from repro_torch.kernels.device_loop.kernel import clock
    from repro_torch.serve import Request
    engine = _engine(drift, tgrid, N, K, S, rtol=0.0, overlap=overlap)
    for i in range(S):
        engine.submit(Request(rid=i, seed=300 + i))
    loop = r_dev > 1 and not overlap
    with torch.no_grad():
        engine.step(r_dev)
        torch.cuda.synchronize()
        ns0 = clock()[1] if loop else 0
        kinds0 = _stats(engine)["dispatch_kinds"]
        r0 = engine.round_count
        t0, p0 = time.time(), time.perf_counter()
        while engine.round_count - r0 < rounds:
            engine.step(r_dev)
        torch.cuda.synchronize()
        wall, t1 = time.perf_counter() - p0, time.time()
        loop_ms = (clock()[1] - ns0) / 1e6 if loop else None
    timed = engine.round_count - r0
    st = _stats(engine)
    if st["served"]:
        raise AssertionError("a lane finished inside the window")
    kinds = {k: v - kinds0[k] for k, v in st["dispatch_kinds"].items()}
    return dict(loop="overlap" if overlap else "sync", r_dev=r_dev,
                rounds=timed, dispatches=kinds,
                wall_ms_per_round=wall * 1e3 / timed,
                loop_clock_ms_per_round=(loop_ms / timed
                                         if loop_ms is not None else None),
                **sampler.between(t0, t1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chords-dit-xl")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=240)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import build_model
    from repro_torch.core import uniform_tgrid
    from repro_torch.diffusion import make_drift
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "arch": args.arch, "n": N, "k": K,
                      "s": S, "rounds": args.rounds}), flush=True)
    cfg, params = build_model(args.arch)
    drift = make_drift(params, cfg.replace(use_kernels=True))
    tgrid = uniform_tgrid(N, device="cuda")
    order = [(False, 1), (False, 8), (True, 1), (True, 8)]
    sampler = Sampler()
    sampler.start()
    try:
        for p in range(args.passes):
            for overlap, r_dev in (order if p % 2 == 0 else order[::-1]):
                rec = window(drift, tgrid, overlap, r_dev, args.rounds,
                             sampler)
                print(json.dumps(dict(rec, card=smi, pass_=p)), flush=True)
                torch.cuda.empty_cache()
    finally:
        sampler.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
