"""Render engine stats for humans — driven by the dict, not by f-strings.

A copy of ``repro.obs.render`` for the port (same names and schema).

``format_stats`` iterates the ``stats()`` dict itself (which in turn is
rendered from the metrics registry), grouping keys by topic; any key it has
no group for lands in the trailing ``other`` group rather than being
silently dropped. That is the anti-drift property the launchers rely on: a
new metric added to ``ContinuousEngine.stats()`` shows up in ``launch/
serve.py`` output with **zero** printing code changes, and a renamed one
can never leave a stale hand-formatted line behind (asserted in
``tests/test_obs.py::test_render_covers_every_stat_key``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# (group label, keys in display order, emit-predicate over the stats dict)
GROUPS: Sequence[Tuple[str, Sequence[str]]] = (
    ("serve", ("served", "rounds_total", "throughput_req_per_round",
               "occupancy", "latency_rounds_p50", "latency_rounds_p95",
               "mean_speedup", "kernel_path", "programs")),
    ("sched", ("policy", "deadline_misses", "deadline_total",
               "deadline_miss_rate", "preemptions",
               "preempted_rounds_wasted", "host_syncs")),
    ("async", ("overlap", "speculations", "speculation_confirms",
               "speculation_rollbacks", "speculated_rounds_wasted",
               "drain_lag_rounds", "dispatches", "round_gap_count",
               "round_gap_mean_s", "round_gap_p95_s", "round_gap_max_s")),
    ("elastic", ("num_slots", "min_slots", "max_slots", "wasted_slot_rounds",
                 "resizes", "grows", "shrinks", "resize_vetoes",
                 "migrations", "buckets_visited", "retraces",
                 "migration_traces")),
    ("lanes", ("lane_modes_enabled", "lane_profile", "lane_skips",
               "lane_served_nonexact", "lane_promotes", "lane_skip_rate")),
)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt(x) for x in v) + "]"
    if isinstance(v, dict):
        return f"<{len(v)} entries>"
    return str(v)


def format_stats(stats: Dict, prefix: str = "[serve]",
                 elide: Sequence[str] = ("accept_rounds_observed",)
                 ) -> List[str]:
    """One line per group; every stats key appears exactly once (elided
    keys are summarized by count so they still show up)."""
    remaining = dict(stats)
    lines: List[str] = []
    for label, keys in GROUPS:
        parts = [f"{k}={_fmt(remaining.pop(k))}" for k in keys
                 if k in remaining]
        if parts:
            lines.append(f"{prefix} {label}: " + " ".join(parts))
    tail = []
    for k in sorted(remaining):
        v = remaining[k]
        tail.append(f"{k}={_fmt(v)}" if k not in elide
                    else f"{k}=<{len(v)} entries>")
    if tail:
        lines.append(f"{prefix} other: " + " ".join(tail))
    return lines
