"""Launch every kernel case of the surface once on the card, and hold each
launch to its description and its plain version.

    python -m repro_torch.analysis.sanitize

For each case of ``surface.kernel_cases`` (at the card's SM count and the
blocks an SM holds, as the wrappers pick ``ssd_chunk``'s head group): the
wrapper runs on fresh seeded arguments, the geometry the library recorded
for the launch (``build.last_launch``: grid, block, cluster, dynamic and
static shared bytes) must equal the case's ``launch_meta``, a launch whose
description opts in above 48 KB must find the kernel's dynamic limit
raised to cover it, and the outputs must equal the plain version's on the
same arguments at the tolerance the smoke's ``kernels`` phase states (0:
bitwise; the 65537-row step and accept cases are bitwise).

It is also the program ``compute-sanitizer`` runs (``--tool memcheck``,
``racecheck``, ``synccheck``, with ``--kernel-name`` limited to the port's
kernels) where that tool works: each kernel once, at every case. Exits 1
on any mismatch. Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
from typing import List

# the port's kernels, for compute-sanitizer's --kernel-name filter
KERNEL_REGEX = ("step_rectify_kernel|step_rectify_accept_kernel|"
                "rmsnorm_rows_kernel|rmsnorm_sweep_kernel|flash_fwd_kernel|"
                "flash_fwd_mma_kernel|ssd_chunk_kernel|device_loop_kernel")


def card_cases(device_index: int = 0) -> List:
    """The surface's kernel cases as the wrappers launch them on this
    card: its SM count and ``ssd_chunk``'s blocks an SM."""
    import torch

    from repro_torch.analysis import surface
    from repro_torch.kernels.ssd_scan.kernel import device_slots

    props = torch.cuda.get_device_properties(device_index)
    return surface.kernel_cases(
        props.multi_processor_count,
        lambda n, hd, lc: device_slots(device_index, n, hd, lc)[1])


def _tensors(tree) -> list:
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _tensors(x)]


def launch_case(case, seed: int = 0) -> dict:
    """One case: the wrapper's launch against its description and its
    plain version. Returns what was found (``ok`` False on a mismatch)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.meta import geometry

    def args():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return case.make("cuda", gen)

    got = case.op(*args())
    torch.cuda.synchronize()
    rec = build.last_launch(case.family)
    want = geometry(case.launch)
    geom_ok = rec is not None and rec.geometry() == want
    smem = case.launch.dynamic_smem
    opt_ok = rec is not None and (
        rec.max_dynamic_smem >= smem if case.launch.smem_opt_in
        else smem + case.launch.static_smem <= 48 * 1024)
    plain = case.plain(*args())
    errs = [float((a.double() - b.double()).abs().max()) if a.numel()
            else 0.0
            for a, b in zip(_tensors(got), _tensors(plain))]
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(_tensors(got), _tensors(plain)))
    out_ok = bitwise if case.tol == 0 else max(errs, default=0.0) <= case.tol
    return {"case": case.name, "geometry": list(rec.geometry()) if rec
            else None, "geometry_equal": geom_ok, "smem_opt_in_ok": opt_ok,
            "registers": rec.registers if rec else None,
            "max_abs_err": max(errs, default=0.0), "bitwise": bitwise,
            "tol": case.tol, "ok": geom_ok and opt_ok and out_ok}


def launch_all(cases) -> List[dict]:
    return [launch_case(c, seed=i) for i, c in enumerate(cases)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sanitize: needs a CUDA card", file=sys.stderr)
        return 2
    found = launch_all(card_cases())
    for r in found:
        print(json.dumps(r), flush=True)
    bad = [r["case"] for r in found if not r["ok"]]
    print(json.dumps({"cases": len(found), "failed": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
