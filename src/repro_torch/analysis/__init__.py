"""Static analysis for the serve surface: four passes, one report — port
of ``repro.analysis``.

``python -m repro_torch.analysis`` lints every program the serve engines
can build (the full bucket ladder + streaming + migration, via
``RoundExecutor.enumerate_programs``) and every CUDA kernel's launch
description at the surface's cases:

* ``graph_lint``     — host syncs, 64-bit values, scalar widening, dead
                       code, state drift, over ``make_fx`` graphs
* ``launch_check``   — block races, out-of-bounds tiles, shared memory,
                       launch limits, oracle shape/dtype agreement
* ``sharding_check`` — DTensor layouts of the slot grid's state against
                       the rule table (needs ranks; see ``--ranks``)
* ``trace_check``    — trace twice per spec, compare graph fingerprints

Findings aggregate into one :class:`Report`; anything not suppressed by
the checked-in ``baseline.json`` fails the gate. See README.md here for
the pass inventory and the triage/suppression workflow. Imports no JAX and
nothing of ``repro``.
"""
from __future__ import annotations

import os

from repro_torch.analysis.report import Baseline, Finding, Report  # noqa: F401

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def run_all(smem_budget_bytes: int = None, sharding: bool = True,
            executor=None, sms: int = 132, slots=None,
            ranks: int = 1) -> Report:
    """Run every pass over the shared serve surface (``surface.py``).
    ``sms`` and ``slots`` pick ``ssd_chunk``'s head group as on a card
    with that many SMs (``surface.kernel_cases``). The sharding pass runs
    in this process's group, or with ``ranks`` > 1 on that many gloo
    ranks spawned for it."""
    from repro_torch.analysis import (graph_lint, launch_check,
                                      sharding_check, surface, trace_check)

    budget = (launch_check.SMEM_BUDGET_BYTES if smem_budget_bytes is None
              else int(smem_budget_bytes))
    ex = surface.make_executor() if executor is None else executor
    records = surface.enumerate_serve_programs(ex)
    cases = surface.kernel_cases(sms, slots)

    report = Report(meta={
        "programs": [r.name for r in records],
        "kernels": [c.name for c in cases],
        "smem_budget_bytes": budget,
        "sms": sms,
    })
    traced: list = []
    report.extend(graph_lint.run(records, traced))
    report.extend(trace_check.run(records, first=traced))
    for case in cases:
        report.extend(launch_check.check_launch(case.launch, budget))
        meta = case.make("meta")
        report.extend(launch_check.check_oracle(case.name, case.alloc,
                                                case.ref, meta))
    if sharding and ranks > 1:
        report.extend(sharding_check.run_on_ranks(ranks))
    elif sharding:
        report.extend(sharding_check.run(
            ex, surface.grid_ladder() + surface.lane_grid_ladder()))
    return report
