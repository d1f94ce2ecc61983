"""Whether compute-sanitizer can check the port's kernels on this machine.

Finds ``compute-sanitizer`` beside ``nvcc`` (``kernels/build.py``'s
``find_nvcc``), prints its version, then runs under each of its tools
``memcheck``, ``racecheck`` and ``synccheck`` first a bare CUDA
allocation and copy in torch, then ``python -m
repro_torch.analysis.sanitize`` (every kernel case of the analysis surface
launched once; ``--kernel-name regex=...`` limited to the port's kernels).
Prints each run's exit code, its ``ERROR SUMMARY`` line and the last lines
of its output, then one JSON object of all.

  python3 benchmarks/torch_sanitizer_probe.py
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("memcheck", "racecheck", "synccheck")
BARE = ("import torch; x = torch.ones(1000, device='cuda'); "
        "print(float((x * 2).sum()))")


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.analysis.sanitize import KERNEL_REGEX
    from repro_torch.kernels.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "compute-sanitizer")
    out = {"tool": tool, "present": os.access(tool, os.X_OK), "runs": {}}
    if not out["present"]:
        print(json.dumps(out), flush=True)
        return 0
    ver = subprocess.run([tool, "--version"], capture_output=True, text=True)
    out["version"] = ver.stdout.strip().splitlines()[-1:]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for t in TOOLS:
        for what, cmd in (
                ("bare", [sys.executable, "-c", BARE]),
                ("cases", ["--kernel-name", f"regex={KERNEL_REGEX}",
                           sys.executable, "-m",
                           "repro_torch.analysis.sanitize"])):
            r = subprocess.run([tool, "--tool", t] + cmd,
                               capture_output=True, text=True,
                               env=env, cwd=ROOT, timeout=600)
            text = r.stdout + r.stderr
            summary = re.findall(r"ERROR SUMMARY: .*", text)
            out["runs"][f"{t}/{what}"] = {
                "rc": r.returncode, "summary": summary[-1:],
                "tail": text.strip().splitlines()[-4:]}
            print(f"{t}/{what}: rc {r.returncode} {summary[-1:]}",
                  flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
