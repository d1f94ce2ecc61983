"""Structured tracer: lifecycle spans + instant events on a bounded ring.

A copy of ``repro.obs.trace`` for the port: the event names and the export
schema are the reference's; the dispatch span brackets the dispatch in a
``torch.profiler.record_function`` range instead of a JAX profiler
annotation, and the JAX lint hooks (``mark_instrumentation``) are left out.

Every event carries **two clocks**: monotonic wall time (``time.monotonic``
relative to the tracer's birth, exported as Chrome-trace microseconds) and
the engine's **round-index logical clock** (the ``round`` arg), so timing
claims can be checked in whichever domain is deterministic — CI contracts
use rounds, gap analysis uses wall time.

Event taxonomy (the names are the stable API — ``repro.obs`` CLI and the
tests key on them; see ``src/repro/obs/README.md``):

* **request lifecycle spans** — ``request/queued`` (submit → committed
  admission, re-opened by an evict-requeue) on the per-request track,
  ``request/compute`` (admission → accept/evict) on the per-slot track
  (slots are Perfetto tracks; a slot's consecutive residents never
  partially overlap);
* **per-dispatch device spans** — ``dispatch/round`` / ``dispatch/multi``
  / ``dispatch/roll`` / ``dispatch/round_keep`` / ``dispatch/admit`` /
  ``dispatch/migrate`` on the host track (the host is single-threaded, so
  these are totally ordered), plus ``verify/readback`` for the blocking
  done-flag readbacks;
* **instants** — ``spec/confirm``, ``spec/rollback``, ``resize/grow``,
  ``resize/shrink``, ``resize/veto``, ``migrate/lanes``, ``preempt``,
  ``deadline/miss``, ``retrace``, ``ckpt/save``, ``ckpt/restore``,
  ``worker/lost``, ``worker/beat``;
* **counter tracks** — ``occupancy`` and ``queue_depth`` sampled at each
  dispatch (Chrome ``ph: "C"`` events; render as area tracks in Perfetto).

Storage is a **bounded ring buffer** with a counted-drops overflow policy:
once ``capacity`` events are buffered, further events are dropped (newest
first — the buffered prefix keeps its span integrity) and counted in
``dropped``; the count is exported in the trace's ``otherData`` so a
truncated trace is never mistaken for a quiet run.

The disabled tracer (``Tracer(enabled=False)``, or the module singleton
:data:`NULL_TRACER` engines default to) is a **zero-allocation no-op**:
every recording method returns immediately on the ``enabled`` check,
``now()`` returns a constant, and span contexts return a shared singleton
— instrumented code paths are bitwise-neutral relative to un-instrumented
ones (asserted in ``tests/test_obs.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

# well-known track groups -> stable Chrome pids (labels via metadata events)
TRACK_PIDS = {"host": 1, "slots": 2, "requests": 3, "train": 4}


class Event(NamedTuple):
    """One buffered trace event (pre-export form)."""

    name: str
    ph: str                  # "X" span | "i" instant | "C" counter
    ts: float                # seconds since tracer birth (monotonic)
    dur: float               # seconds ("X" only; 0 otherwise)
    track: Tuple[str, int]   # (group, lane) -> Chrome (pid, tid)
    args: dict
    end: float = 0.0         # the end reading ("X" only): ts + dur need
                             # not equal it in floating point


class _NullSpan:
    """Reusable no-op context manager (the disabled tracer's span)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _DispatchSpan:
    """Context manager emitting one dispatch span on exit; also enters a
    ``torch.profiler.record_function`` range so an optional
    ``torch.profiler`` capture aligns device activity with these spans."""

    __slots__ = ("_tracer", "_name", "_args", "_round", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, round_idx, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._round = round_idx
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        self._t0 = self._tracer.now()
        import torch.profiler
        self._ann = torch.profiler.record_function(self._name)
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer.span(self._name, self._t0, round_idx=self._round,
                          track=("host", 0), **self._args)
        return False


class Tracer:
    """Bounded structured-event recorder (see module docstring)."""

    def __init__(self, enabled: bool = True, capacity: int = 1 << 16):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.events: List[Event] = []
        self.dropped = 0
        self._t0 = time.monotonic() if self.enabled else 0.0
        # track labels registered on first use -> exported as metadata
        self._tracks: Dict[Tuple[str, int], str] = {}

    # -- clock ----------------------------------------------------------------

    def now(self) -> float:
        """Seconds since tracer birth (0.0 when disabled — callers pass the
        value straight back into ``span``, which is a no-op then too)."""
        if not self.enabled:
            return 0.0
        return time.monotonic() - self._t0

    # -- recording ------------------------------------------------------------

    def _push(self, ev: Event) -> None:
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        self.events.append(ev)

    def instant(self, name: str, round_idx: Optional[int] = None,
                track: Tuple[str, int] = ("host", 0), **args) -> None:
        if not self.enabled:
            return
        if round_idx is not None:
            args["round"] = int(round_idx)
        self._push(Event(name, "i", self.now(), 0.0, track, args))

    def span(self, name: str, t0: float, round_idx: Optional[int] = None,
             track: Tuple[str, int] = ("host", 0),
             t1: Optional[float] = None, **args) -> None:
        """Complete span from ``t0`` (a ``now()`` reading) to ``t1``/now."""
        if not self.enabled:
            return
        if round_idx is not None:
            args["round"] = int(round_idx)
        end = max(t0, self.now() if t1 is None else t1)
        self._push(Event(name, "X", t0, end - t0, track, args, end))

    def counter(self, name: str, value: float,
                track: Tuple[str, int] = ("host", 0)) -> None:
        if not self.enabled:
            return
        self._push(Event(name, "C", self.now(), 0.0, track,
                         {"value": float(value)}))

    def dispatch_span(self, name: str, round_idx: Optional[int] = None,
                      **args):
        """Context manager for one device-program dispatch: measures the
        host-side dispatch duration, emits ``dispatch/<name>`` on the host
        track, and brackets the dispatch in a profiler range."""
        if not self.enabled:
            return _NULL_SPAN
        return _DispatchSpan(self, f"dispatch/{name}", round_idx, args)

    def label_track(self, track: Tuple[str, int], label: str) -> None:
        """Optional human label for a track lane (e.g. slot 3 -> "slot 3");
        exported as Chrome thread_name metadata."""
        if not self.enabled:
            return
        self._tracks[track] = label

    # -- introspection --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.events)

    def count(self, name: str) -> int:
        return sum(1 for e in self.events if e.name == name)

    def named(self, name: str) -> List[Event]:
        return [e for e in self.events if e.name == name]

    @property
    def track_labels(self) -> Dict[Tuple[str, int], str]:
        return dict(self._tracks)


NULL_TRACER = Tracer(enabled=False)

