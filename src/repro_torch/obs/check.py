"""Trace/snapshot analysis: ``summarize``, ``diff``, ``check``.

A copy of ``repro.obs.check`` for the port: the same contracts, report
lines and verdicts on the same document. These back ``python -m
repro_torch.obs`` (see ``__main__.py``) and are plain
functions over loaded JSON documents so tests — and the benchmarks — can
call them in-process.

* :func:`summarize` — per-phase wall-time breakdown (dispatch / readback /
  request queued / compute), event counts, top round-gap offenders and the
  slots most often hit by speculation rollbacks.
* :func:`diff` — compare two metrics snapshots (bare snapshot files or
  traces with embedded snapshots): every common scalar gets a delta; a
  metric whose name marks it **lower-is-better** (:data:`LOWER_BETTER`
  prefixes/suffixes) and whose relative increase exceeds the threshold is
  flagged as a regression (nonzero exit from the CLI).
* :func:`check` — machine-verifies the async-runtime contracts from a
  single trace artifact instead of ad-hoc benchmark asserts:
  **round-gap** (mean busy-grid gap between device dispatches below
  ``max_gap_s``), **host-sync amortization** (done-flag readbacks strictly
  below total rounds when the overlap runtime served the trace), and
  **rollback bounds** (rollbacks never exceed speculations; wasted
  dispatched rounds never exceed rollbacks — each misprediction discards at
  most the one in-flight round). Structural validity — required event
  fields, spans nest-or-disjoint per track — is checked first, so a
  malformed trace fails loudly rather than vacuously passing.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Tuple

from repro_torch.obs.metrics import metric_scalar

# metric name fragments where an increase is a regression (diff direction)
LOWER_BETTER = (
    "latency", "gap", "host_syncs", "rollback", "wasted", "miss",
    "preempt", "retrace", "dropped", "drain_lag", "step_time",
)

REQUIRED_EVENT_KEYS = {"name", "ph", "pid", "tid", "ts"}


def _spans(doc: dict) -> List[dict]:
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def _instants(doc: dict) -> List[dict]:
    return [e for e in doc["traceEvents"] if e.get("ph") == "i"]


def _metrics(doc: dict) -> dict:
    return doc.get("otherData", {}).get("metrics", {})


# -- structural validation ----------------------------------------------------

def validate_structure(doc: dict) -> List[str]:
    """Structural problems in a Chrome trace doc ([] == valid).

    Checks every event for the required trace-event fields and every
    track's complete-spans for the nest-or-disjoint property Perfetto
    assumes (two spans on one track either don't overlap or one contains
    the other — partial overlap renders as garbage)."""
    problems: List[str] = []
    for i, e in enumerate(doc.get("traceEvents", [])):
        # metadata events (process_name/thread_name) carry no timestamp in
        # the Chrome trace-event spec
        required = REQUIRED_EVENT_KEYS - ({"ts"} if e.get("ph") == "M"
                                          else set())
        missing = required - set(e)
        if missing:
            problems.append(f"event[{i}] {e.get('name')!r}: missing "
                            f"{sorted(missing)}")
            continue
        if e["ph"] == "X" and e.get("dur", -1.0) < 0.0:
            problems.append(f"event[{i}] {e['name']!r}: X event with "
                            f"dur={e.get('dur')}")
    by_track = collections.defaultdict(list)
    for e in _spans(doc):
        by_track[(e["pid"], e["tid"])].append(e)
    for track, spans in sorted(by_track.items()):
        spans.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        open_stack: List[Tuple[float, float, str]] = []
        for e in spans:
            t0, t1 = e["ts"], e["ts"] + e.get("dur", 0.0)
            while open_stack and open_stack[-1][1] <= t0 + 1e-9:
                open_stack.pop()
            if open_stack and t1 > open_stack[-1][1] + 1e-9:
                problems.append(
                    f"track pid={track[0]} tid={track[1]}: span "
                    f"{e['name']!r} [{t0:.1f},{t1:.1f}]us partially "
                    f"overlaps {open_stack[-1][2]!r} "
                    f"(ends {open_stack[-1][1]:.1f}us)")
            open_stack.append((t0, t1, e["name"]))
    return problems


# -- summarize ---------------------------------------------------------------

def summarize(doc: dict, top: int = 5) -> List[str]:
    lines: List[str] = []
    other = doc.get("otherData", {})
    spans, instants = _spans(doc), _instants(doc)
    lines.append(f"events: {len(doc['traceEvents'])} "
                 f"({len(spans)} spans, {len(instants)} instants, "
                 f"{other.get('dropped', 0)} dropped)")

    phase = collections.defaultdict(lambda: [0, 0.0])
    for e in spans:
        p = phase[e["name"]]
        p[0] += 1
        p[1] += e.get("dur", 0.0)
    lines.append("per-phase wall time:")
    for name, (n, dur) in sorted(phase.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {name:<24} {n:>6}x  {dur / 1e3:>10.2f} ms")

    counts = collections.Counter(e["name"] for e in instants)
    if counts:
        lines.append("instants: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))

    gaps = [(e["args"]["gap_s"], e) for e in spans
            if e["name"].startswith("dispatch/")
            and e.get("args", {}).get("gap_s") is not None]
    if gaps:
        mean = sum(g for g, _ in gaps) / len(gaps)
        lines.append(f"round gaps: {len(gaps)} measured, "
                     f"mean {mean * 1e3:.3f} ms")
        lines.append(f"top {top} gap offenders:")
        for g, e in sorted(gaps, key=lambda ge: -ge[0])[:top]:
            lines.append(f"  {g * 1e3:>8.3f} ms before {e['name']} "
                         f"@round {e.get('args', {}).get('round', '?')}")

    rb = collections.Counter()
    for e in instants:
        if e["name"] == "spec/rollback":
            for s in e.get("args", {}).get("slots", []):
                rb[s] += 1
    if rb:
        lines.append("rollback offenders (slot: count): " + ", ".join(
            f"{s}: {n}" for s, n in rb.most_common(top)))
    return lines


# -- diff --------------------------------------------------------------------

def _scalar_items(snap: dict) -> dict:
    """Flatten a snapshot into {display_name: float} (histograms expand to
    .count/.mean/.p50/.p95/.max)."""
    out = {}
    for name, m in snap.get("metrics", {}).items():
        if m.get("type") == "histogram":
            for f in ("count", "mean", "p50", "p95", "max"):
                out[f"{name}.{f}"] = float(m.get(f, 0.0))
        else:
            v = m.get("value")
            if isinstance(v, (int, float)):
                out[name] = float(v)
    return out


def is_lower_better(name: str) -> bool:
    return any(frag in name for frag in LOWER_BETTER)


def diff(snap_a: dict, snap_b: dict, threshold: float = 0.25,
         min_abs: float = 1e-9) -> Tuple[List[str], List[str]]:
    """Compare snapshots A (baseline) -> B (candidate).

    Returns ``(lines, regressions)``: all deltas rendered, plus the subset
    of lower-is-better metrics whose relative increase exceeds
    ``threshold`` (relative to ``max(|A|, 1)`` so zero baselines don't
    divide away — a 0 -> 3 rollback jump IS a regression)."""
    a, b = _scalar_items(snap_a), _scalar_items(snap_b)
    lines: List[str] = []
    regressions: List[str] = []
    for name in sorted(set(a) | set(b)):
        va, vb = a.get(name), b.get(name)
        if va is None or vb is None:
            lines.append(f"  {name:<44} "
                         f"{'--' if va is None else f'{va:.6g}':>12} -> "
                         f"{'--' if vb is None else f'{vb:.6g}':>12}  "
                         f"(only in {'B' if va is None else 'A'})")
            continue
        delta = vb - va
        if abs(delta) < min_abs:
            continue
        rel = delta / max(abs(va), 1.0)
        tag = ""
        if is_lower_better(name) and rel > threshold:
            tag = "  REGRESSION"
            regressions.append(name)
        lines.append(f"  {name:<44} {va:>12.6g} -> {vb:>12.6g}  "
                     f"({rel:+.1%}){tag}")
    return lines, regressions


# -- check -------------------------------------------------------------------

def check(doc: dict, max_gap_s: float = 0.25,
          max_rollbacks: Optional[int] = None) -> Tuple[bool, List[str]]:
    """Verify the async-serve timing contracts from one trace artifact.

    Returns ``(ok, report_lines)``. Contracts (skipped with a note when the
    trace lacks the needed data rather than passing vacuously):

    1. structural validity (see :func:`validate_structure`);
    2. round-gap: mean busy-grid gap between device dispatches (the
       ``gap_s`` arg each dispatch span carries — idle periods excluded at
       the source) below ``max_gap_s``;
    3. host-sync amortization: ``serve.host_syncs`` <= ``rounds_total``,
       and **strictly** below when the overlap runtime served the trace;
    4. rollback bounds: rollbacks <= speculations, wasted dispatched
       rounds <= rollbacks ("at most the one in-flight round per
       misprediction"), and — when ``max_rollbacks`` is given — an
       absolute cap (deterministic rtol=0 traces use 0);
    5. lane-commit: heterogeneous-lane instants (``lane/skip``,
       ``lane/promote``) are emitted ONLY at the drain commit point —
       each (name, rid) appears at most once, and every rid they name
       must belong to a completed ``request/compute`` span (a rolled-back
       speculative step must never leave phantom lane events).
    """
    lines: List[str] = []
    ok = True

    def result(label: str, passed: Optional[bool], detail: str):
        nonlocal ok
        if passed is None:
            lines.append(f"  SKIP {label}: {detail}")
            return
        ok = ok and passed
        lines.append(f"  {'PASS' if passed else 'FAIL'} {label}: {detail}")

    problems = validate_structure(doc)
    result("structure", not problems,
           "valid Chrome trace-event JSON" if not problems
           else "; ".join(problems[:5]))

    snap = _metrics(doc)

    gaps = [e["args"]["gap_s"] for e in _spans(doc)
            if e["name"].startswith("dispatch/")
            and e.get("args", {}).get("gap_s") is not None]
    if gaps:
        mean = sum(gaps) / len(gaps)
        result("round-gap", mean < max_gap_s,
               f"mean busy gap {mean * 1e3:.3f} ms over {len(gaps)} "
               f"dispatches (limit {max_gap_s * 1e3:.0f} ms)")
    else:
        result("round-gap", None, "no dispatch gap samples in trace")

    syncs = metric_scalar(snap, "serve.host_syncs")
    rounds = metric_scalar(snap, "serve.rounds_total")
    overlap = metric_scalar(snap, "serve.overlap")
    if syncs is None or rounds is None:
        result("host-syncs", None, "no serve metrics snapshot in trace")
    elif overlap:
        result("host-syncs", syncs < rounds,
               f"{syncs:.0f} readbacks for {rounds:.0f} rounds "
               f"(overlap run: must be strictly amortized)")
    else:
        result("host-syncs", syncs <= rounds,
               f"{syncs:.0f} readbacks for {rounds:.0f} rounds")

    rb = metric_scalar(snap, "serve.spec.rollbacks")
    spec = metric_scalar(snap, "serve.spec.count")
    wasted = metric_scalar(snap, "serve.spec.rounds_wasted")
    if rb is None:
        result("rollback-bounds", None, "no speculation metrics in trace")
    else:
        detail = (f"{rb:.0f} rollbacks / {spec:.0f} speculations, "
                  f"{wasted:.0f} rounds wasted")
        result("rollback-bounds", rb <= spec and wasted <= rb, detail)
        if max_rollbacks is not None:
            result("rollback-cap", rb <= max_rollbacks,
                   f"{rb:.0f} rollbacks (cap {max_rollbacks})")

    lane_ev = [e for e in _instants(doc)
               if e["name"].startswith("lane/")]
    if not lane_ev:
        result("lane-commit", None, "no lane instants in trace")
    else:
        problems = []
        seen = collections.Counter(
            (e["name"], e.get("args", {}).get("rid")) for e in lane_ev)
        dupes = [k for k, n in seen.items() if n > 1]
        if dupes:
            problems.append(f"duplicate lane instants {sorted(dupes)[:3]}")
        # commit-point contract: a lane instant's rid must have a finished
        # residency span (request/compute carrying rounds_used) — lane
        # events for requests that never drained are phantoms from a
        # speculative step that should have been rolled back silently
        finished = {e.get("args", {}).get("rid") for e in _spans(doc)
                    if e["name"] == "request/compute"
                    and "rounds_used" in e.get("args", {})}
        orphans = sorted({e.get("args", {}).get("rid") for e in lane_ev}
                         - finished)
        if orphans:
            problems.append(f"lane instants for undrained rids {orphans[:5]}")
        result("lane-commit", not problems,
               f"{len(lane_ev)} lane instants, all at drain commits"
               if not problems else "; ".join(problems))
    return ok, lines
