"""Exporters: Chrome trace-event JSON (Perfetto-loadable) + snapshot files.

A copy of ``repro.obs.export`` for the port: the schema (name and version)
is the reference's, so either package's ``check`` reads either's traces.

``chrome_trace(tracer, metrics=...)`` renders the tracer's event buffer in
the Chrome trace-event format (the JSON object form — ``traceEvents`` +
``displayTimeUnit`` + ``otherData``), which https://ui.perfetto.dev opens
directly. Conventions:

* tracks map to (pid, tid): the ``("slots", s)`` group puts **each slot on
  its own thread track** under the "slots" process, requests under
  "requests", the host loop under "host" — labeled via ``process_name`` /
  ``thread_name`` metadata events;
* spans are **complete events** (``ph: "X"``, ts + dur, microseconds) —
  emitted only at commit points, so they are well-nested per track by
  construction; ``dur`` comes from the two converted readings
  (:func:`span_dur_us`), so a span that ends at the reading where the next
  one starts abuts it exactly in microseconds at any trace age;
* instants are thread-scoped (``ph: "i"``, ``s: "t"``); counters are
  ``ph: "C"`` (Perfetto renders them as area tracks);
* ``otherData`` carries the trace schema/version, the ring-buffer drop
  count, free-form run metadata, and (when a registry is passed) the full
  **metrics snapshot** — one artifact holds both the timeline and the
  numbers, which is what lets ``python -m repro_torch.obs check`` verify the
  serve-timing contracts from a single file.
"""
from __future__ import annotations

import json
import math
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TRACK_PIDS, Tracer

TRACE_SCHEMA = "repro.obs.trace"
TRACE_VERSION = 1


def _track_ids(track, extra_pids):
    group, lane = track
    pid = TRACK_PIDS.get(group)
    if pid is None:
        pid = extra_pids.setdefault(group, 100 + len(extra_pids))
    return pid, int(lane)


def span_dur_us(ts_us: float, end_us: float) -> float:
    """The duration to write for a span from ``ts_us`` to ``end_us``: the
    one nearest ``end_us - ts_us`` whose sum with ``ts_us`` does not pass
    ``end_us`` (and equals it wherever a float can), so spans that share a
    reading abut exactly. Converting ``ts`` and ``dur`` separately does not:
    past 2**23 us (8.4 s) one ulp of a timestamp exceeds a checker's slack."""
    dur = max(0.0, end_us - ts_us)
    while dur > 0.0 and ts_us + dur > end_us:
        dur = math.nextafter(dur, 0.0)
    if ts_us + dur < end_us:
        up = math.nextafter(dur, math.inf)
        if ts_us + up == end_us:
            dur = up
    return dur


def chrome_trace(tracer: Tracer, metrics: Optional[MetricsRegistry] = None,
                 meta: Optional[dict] = None) -> dict:
    """Render the tracer buffer as a Chrome trace-event JSON document."""
    events = []
    extra_pids: dict = {}
    seen_tracks = {}
    for ev in tracer.events:
        pid, tid = _track_ids(ev.track, extra_pids)
        seen_tracks[(pid, tid)] = ev.track
        ts_us = ev.ts * 1e6
        rec = {"name": ev.name, "ph": ev.ph, "pid": pid, "tid": tid,
               "ts": ts_us, "cat": ev.name.split("/")[0]}
        if ev.ph == "X":
            rec["dur"] = span_dur_us(ts_us, ev.end * 1e6)
            rec["args"] = ev.args
        elif ev.ph == "i":
            rec["s"] = "t"
            rec["args"] = ev.args
        elif ev.ph == "C":
            rec["args"] = {"value": ev.args.get("value", 0.0)}
        events.append(rec)

    # metadata: name every process group and thread lane we touched
    labels = tracer.track_labels
    named_pids = set()
    meta_events = []
    for (pid, tid), track in sorted(seen_tracks.items()):
        group, lane = track
        if pid not in named_pids:
            named_pids.add(pid)
            meta_events.append({"name": "process_name", "ph": "M",
                                "pid": pid, "tid": 0,
                                "args": {"name": group}})
        label = labels.get(track, f"{group} {lane}"
                           if lane or group != "host" else "host loop")
        meta_events.append({"name": "thread_name", "ph": "M",
                            "pid": pid, "tid": tid,
                            "args": {"name": label}})

    other = {"schema": TRACE_SCHEMA, "version": TRACE_VERSION,
             "dropped": tracer.dropped, "events": len(tracer.events)}
    if meta:
        other["meta"] = dict(meta)
    if metrics is not None:
        other["metrics"] = metrics.snapshot()
    return {"traceEvents": meta_events + events,
            "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(path: str, tracer: Tracer,
                       metrics: Optional[MetricsRegistry] = None,
                       meta: Optional[dict] = None) -> dict:
    doc = chrome_trace(tracer, metrics=metrics, meta=meta)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace-event JSON document")
    return doc
