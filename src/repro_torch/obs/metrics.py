"""Unified metrics registry: counters, gauges, reservoir histograms.

A copy of ``repro.obs.metrics`` for the port (same names and schema).

One :class:`MetricsRegistry` per component (engine / executor / trainer —
or one shared, when the engine builds its own executor it hands its
registry down) is the **single source of truth** behind the ad-hoc
``stats()`` dicts that used to scatter scalar counters across
``serve/engine.py``, ``serve/executor.py``, ``sched/cost.py`` and
``train/trainer.py``. Metric names are stable dotted paths
(``serve.host_syncs``, ``executor.retraces``, ``train.step_time_s`` — the
full naming scheme is documented in ``src/repro/obs/README.md``), and
``snapshot()`` serializes the whole registry under a **versioned schema**
(:data:`METRICS_SCHEMA` / :data:`METRICS_VERSION`) so the ``repro.obs``
CLI can diff two runs without guessing at key meanings.

Histograms are **fixed-size reservoirs** (Vitter's Algorithm R with a
deterministic per-histogram RNG): ``count`` / ``sum`` / ``min`` / ``max``
are always exact; percentiles are exact while ``count <= capacity`` and
an unbiased uniform-sample estimate beyond — which is what lets a
week-long serving process keep p50/p95 without growing host memory
(the fix for the previously unbounded ``ContinuousEngine._latencies`` /
``_speedups`` lists).

Counters accept negative increments on purpose: the async engine applies
scheduling decisions *speculatively* and must be able to undo the host
side of a rolled-back decision (see ``_DecisionUndo`` in
``serve/engine.py``).
"""
from __future__ import annotations

import json
import math
import random
from typing import Dict, List, Optional, Union

METRICS_SCHEMA = "repro.obs.metrics"
METRICS_VERSION = 1

DEFAULT_RESERVOIR = 2048


class Counter:
    """Monotone-by-convention cumulative count (negative ``inc`` allowed
    for speculative-undo bookkeeping)."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Fixed-size uniform reservoir + exact count/sum/min/max.

    Percentile semantics: **exact** over all observations while
    ``count <= capacity``; once the reservoir is full, each new value
    replaces a uniformly random resident (Algorithm R), so percentiles
    become an unbiased estimate over a uniform sample of the full stream.
    ``count``/``sum``/``min``/``max`` (and hence ``mean``) stay exact
    forever. The RNG is seeded per histogram name, so runs are
    reproducible.
    """

    kind = "histogram"

    def __init__(self, name: str, capacity: int = DEFAULT_RESERVOIR):
        if capacity < 1:
            raise ValueError(f"histogram capacity must be >= 1: {capacity}")
        self.name = name
        self.capacity = int(capacity)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._values: List[float] = []
        self._rng = random.Random(hash(name) & 0xFFFFFFFF)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._values) < self.capacity:
            self._values.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._values[j] = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 when empty (matches the old stats() paths)."""
        if not self._values:
            return 0.0
        vals = sorted(self._values)
        if len(vals) == 1:
            return vals[0]
        # linear interpolation, numpy-compatible
        pos = (q / 100.0) * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1 - frac) + vals[hi] * frac

    def snapshot(self) -> dict:
        return {
            "type": self.kind,
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "reservoir_size": len(self._values),
            "capacity": self.capacity,
            "exact": self.count <= self.capacity,
        }


class MetricsRegistry:
    """Name-keyed registry; ``counter``/``gauge``/``histogram`` create on
    first use and return the same instrument thereafter (asking for an
    existing name with a different kind raises — name collisions across
    kinds are always bugs)."""

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  capacity: int = DEFAULT_RESERVOIR) -> Histogram:
        return self._get(name, Histogram, capacity=capacity)

    def names(self, prefix: str = "") -> List[str]:
        return sorted(n for n in self._metrics if n.startswith(prefix))

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def snapshot(self) -> dict:
        """Versioned JSON-able snapshot of every registered metric."""
        return {
            "schema": METRICS_SCHEMA,
            "version": METRICS_VERSION,
            "metrics": {n: m.snapshot()
                        for n, m in sorted(self._metrics.items())},
        }

    def write_snapshot(self, path: str) -> dict:
        doc = self.snapshot()
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        return doc


def load_snapshot(path: str) -> dict:
    """Load a metrics snapshot from either a bare snapshot file or a Chrome
    trace file with the snapshot embedded at ``otherData.metrics``."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") == METRICS_SCHEMA:
        return doc
    embedded = doc.get("otherData", {}).get("metrics")
    if embedded is not None and embedded.get("schema") == METRICS_SCHEMA:
        return embedded
    raise ValueError(
        f"{path}: neither a {METRICS_SCHEMA} snapshot nor a trace with an "
        f"embedded one (schema={doc.get('schema')!r})")


def metric_scalar(snap: dict, name: str,
                  field: str = "value") -> Optional[float]:
    """Pull one scalar out of a snapshot doc (``None`` when absent).
    For histograms pass ``field`` = count/sum/mean/p50/p95/p99/min/max."""
    m = snap.get("metrics", {}).get(name)
    if m is None:
        return None
    if m.get("type") == "histogram":
        return m.get(field if field != "value" else "mean")
    return m.get("value")
