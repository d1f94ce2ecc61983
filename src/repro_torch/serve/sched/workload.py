"""Canonical serve workloads + the arrival-clock driver — port of
``repro.serve.sched.workload``.

Two traces: :func:`sla_demo_trace` (deadline pressure, below; the trace
with mid-run arrivals and deadlines on which the overlap engine
speculates) and :func:`bursty_trace` (burst → lull → burst, the
demand-paged capacity demo). A request carries ``seed=key_base + rid``
where the reference's carries a PRNG key made from the same number:
arrivals, rids, deadlines and tolerances are the reference's exactly, the
noise is drawn by torch from the seed (the parity tests inject the
reference's draws through ``Request.x0`` instead).

Shape of the trace (all knobs scale with ``n_steps``):

* ``bulk`` requests arrive first with NO deadline — they fill every slot and,
  under FIFO, hold the queue hostage;
* ``urgent`` requests arrive a few rounds later with a deadline only barely
  above their own compute time: meetable only if admitted (nearly)
  immediately — FIFO queues them behind bulk (miss), EDF reorders the queue
  but still waits for a natural drain (miss), EDF-preempt evicts a bulk lane
  that has barely started (cheap: the evicted rounds are the only waste) and
  meets it;
* ``soft`` requests arrive with a deadline loose enough that queue
  *reordering* alone rescues them: EDF and EDF-preempt meet them, FIFO
  (which serves the no-deadline bulk first) misses them.

With ``rtol=0.0`` on every request each lane runs exactly ``n_steps``
rounds (the engine force-accepts core 0's sequential solve), making miss
counts — and the fifo-vs-preempt gap — fully deterministic for CI.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.serve.engine import ContinuousEngine, Request, SampleOut


def sla_engine_kwargs(n_steps: int) -> dict:
    """Engine knobs the demo trace assumes: starvation aging slower than the
    trace horizon (otherwise the no-deadline bulk is promoted past the soft
    deadline class mid-trace — correct behavior, but it would entangle the
    aging knob with the miss-rate comparison the CI asserts)."""
    return {"aging_rounds": 8 * n_steps}


def sla_demo_trace(n_steps: int, key_base: int = 1000,
                   bulk: int = 4, urgent: int = 2, soft: int = 2,
                   rtol: Optional[float] = 0.0
                   ) -> Tuple[List[Request], List[int]]:
    """Returns ``(requests, arrival_rounds)`` sorted by arrival."""
    n = n_steps
    reqs: List[Tuple[int, Request]] = []
    rid = 0
    for _ in range(bulk):
        reqs.append((0, Request(rid=rid, seed=key_base + rid,
                                rtol=rtol)))
        rid += 1
    for j in range(urgent):
        # deadline n + n//4 from an arrival at 2(j+1): meetable only if a
        # lane opens within ~n//4 rounds of arrival — i.e. by preemption
        reqs.append((2 * (j + 1),
                     Request(rid=rid, seed=key_base + rid,
                             rtol=rtol, deadline_rounds=n + n // 4)))
        rid += 1
    for j in range(soft):
        # deadline 3n from an early arrival: met iff the request is ordered
        # ahead of the no-deadline bulk backlog (third service wave) — queue
        # REORDERING alone rescues it, no preemption required
        reqs.append((3 + j,
                     Request(rid=rid, seed=key_base + rid,
                             rtol=rtol, deadline_rounds=3 * n)))
        rid += 1
    reqs.sort(key=lambda ar: (ar[0], ar[1].rid))
    return [r for _, r in reqs], [a for a, _ in reqs]


def bursty_trace(n_steps: int, key_base: int = 7000,
                 burst: int = 6, quiet: int = 3,
                 quiet_gap: Optional[int] = None,
                 rtol: Optional[float] = 0.0
                 ) -> Tuple[List[Request], List[int]]:
    """The demand-paged capacity demo trace: burst → lull → burst.

    * a **burst** of ``burst`` simultaneous requests at round 0 — far beyond
      a small grid's capacity, so an elastic engine pages slots in (and a
      fixed ``S = min_slots`` grid queues deeply: its p95 latency is the
      bound elastic must beat);
    * a **lull**: ``quiet`` requests arriving one at a time, ``quiet_gap``
      rounds apart (default ``2 * n_steps`` — strictly more than one
      request's compute, so occupancy stays at one lane) — a fixed
      ``S = max_slots`` grid burns dead-lane rounds here, an elastic engine
      pages slots out behind the hysteresis window;
    * a second **burst** re-entering the top capacity bucket — which must be
      a trace-cache HIT (no thrash retraces: total retraces stay bounded by
      the number of *distinct* buckets ever visited).

    With ``rtol=0.0`` every lane runs exactly ``n_steps`` rounds, making
    wasted-round and latency comparisons deterministic for CI.
    """
    n = n_steps
    gap = quiet_gap if quiet_gap is not None else 2 * n
    reqs: List[Request] = []
    arrivals: List[int] = []
    rid = 0

    def add(arrival: int):
        nonlocal rid
        reqs.append(Request(rid=rid, seed=key_base + rid,
                            rtol=rtol))
        arrivals.append(arrival)
        rid += 1

    for _ in range(burst):
        add(0)
    lull_start = 3 * n  # past the first burst's drain even at S = min
    for j in range(quiet):
        add(lull_start + j * gap)
    for _ in range(burst):
        add(lull_start + quiet * gap)
    return reqs, arrivals


def drive(engine: ContinuousEngine, reqs: List[Request],
          arrivals: List[int], max_rounds_on_device: int = 1,
          round_limit: int = 100_000) -> dict:
    """Serve a timed trace against the engine's round clock.

    Arrivals are submitted once ``engine.round_count`` reaches their round;
    when the engine is fully idle the clock jumps to the next arrival.
    Returns {rid: SampleOut}.
    """
    done: dict[int, SampleOut] = {}
    pending = sorted(zip(arrivals, reqs), key=lambda ar: (ar[0], ar[1].rid))
    while pending or len(engine.queue) or engine.has_inflight:
        while pending and pending[0][0] <= engine.round_count:
            engine.submit(pending.pop(0)[1])
        if pending and not len(engine.queue) and not engine.has_inflight:
            engine.round_count = pending[0][0]  # idle until next arrival
            continue
        done.update(dict(engine.step(
            max_rounds_on_device=max_rounds_on_device)))
        if engine.round_count > round_limit:
            raise RuntimeError(f"trace did not drain by round {round_limit}")
    return done
