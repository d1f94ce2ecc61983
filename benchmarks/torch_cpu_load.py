"""Wall time of the serving launcher on the CPU beside busy processes.

Starts ``--busy`` torch processes that multiply matrices for as long as the
measurement lasts (each at torch's default intra-op thread count), then
runs each launcher variant once, in turns, from each checkout given, and
prints one line a run: checkout, variant, exit code, wall seconds. Without
``--busy`` it measures the idle machine.

  python benchmarks/torch_cpu_load.py --busy 6 --repo . --repo build/parent

A variant that runs past ``--timeout`` seconds is cut and reported with
exit code 124.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

VARIANTS = {"sync": ["--device-rounds", "8"],
            "overlap": ["--device-rounds", "8", "--overlap", "--use-kernels"]}
BUSY = ("import torch, time\n"
        "a = torch.randn(512, 512)\n"
        "while True:\n"
        "    a = torch.tanh(a @ a) * 0.5\n")


def run(repo: str, variant: str, timeout: float) -> tuple:
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    t0 = time.perf_counter()
    try:
        rc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
             "--device", "cpu", *VARIANTS[variant]], cwd=repo, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        rc = 124
    return rc, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--repo", action="append", default=None)
    ap.add_argument("--variant", action="append", default=None,
                    choices=sorted(VARIANTS))
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    repos = args.repo or ["."]
    variants = args.variant or ["sync", "overlap"]
    busy = [subprocess.Popen([sys.executable, "-c", BUSY])
            for _ in range(args.busy)]
    try:
        time.sleep(3 if busy else 0)
        for repo in repos:
            for v in variants:
                rc, wall = run(repo, v, args.timeout)
                print(f"{repo} {v} busy={args.busy} rc={rc} "
                      f"wall={wall:.1f}s", flush=True)
    finally:
        for p in busy:
            p.kill()
            p.wait()


if __name__ == "__main__":
    main()
