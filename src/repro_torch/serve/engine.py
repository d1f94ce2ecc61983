"""CHORDS serving runtimes — port of ``repro.serve.engine``.

``StreamingSampler`` runs Algorithm 1 and stops as soon as two consecutive
streamed outputs agree within rtol (paper Section 5). ``ChordsEngine`` is
the static-batch server around it: partial batches are padded to
``max_batch`` and a batch is held until its slowest request converges.
``ContinuousEngine`` serves a ``[S, K, ...]`` slot x core grid: every step
asks the scheduling policy which queued requests to admit (and, for
``edf-preempt``, which lanes to evict), runs one lockstep round for every
live slot, reads the done flags back in one transfer and drains finished
slots.

Noise: a :class:`Request` carries ``seed`` — its init noise is drawn on the
engine's device from ``torch.Generator(device).manual_seed(seed)`` — or an
explicit ``x0``; the parity tests inject the JAX package's draws through
``x0`` (``jax.random`` streams cannot be reproduced in torch).

Ported: the synchronous engine with FIFO / EDF / EDF-preempt. Not yet
(each raises ``NotImplementedError``): ``overlap=True`` (ROADMAP.md queue
1 item 5), elastic ``min_slots``/``max_slots`` (item 6), ``lane_profile``
(item 7), ``max_rounds_on_device > 1`` (item 8), ``write_trace`` (item 9).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.init_sequence import make_sequence
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.serve.executor import (GridSpec, RoundExecutor,
                                        StreamSpec)
from repro_torch.serve.sched.cost import CostModel
from repro_torch.serve.sched.policy import (Decision, EngineView, LaneView,
                                            get_policy)
from repro_torch.serve.sched.queue import AdmissionQueue, QueueItem


def _not_ported(what: str, item: int, title: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue 1 item {item} "
        f"({title})")


@dataclasses.dataclass
class SampleOut:
    """Batched samplers carry per-request arrays in the scalar fields."""
    sample: torch.Tensor
    rounds_used: object  # int, or [B] array when batched
    accepted_core: object
    speedup: object
    latency_rounds: Optional[int] = None  # queue wait + compute (engines)


@dataclasses.dataclass
class Request:
    """One sampling request. The init noise is ``x0`` when given (latent
    shaped), else drawn on the engine's device from ``seed``."""
    rid: int
    seed: int = 0
    x0: Optional[torch.Tensor] = None
    cond: Optional[object] = None
    priority: int = 0  # higher = more aggressive init sequence
    rtol: Optional[float] = None  # per-request accept tolerance
    deadline_rounds: Optional[int] = None  # SLA, in lockstep rounds
    mode: str = "exact"  # lane mode; honored only with lane profiles,
    # which are not ported yet — the homogeneous grid serves every mode
    # exact, as the reference's does


def request_noise(req: Request, latent_shape, device,
                  dtype=torch.float32) -> torch.Tensor:
    """The request's init noise on ``device``: ``req.x0`` when given, else
    a standard normal draw from ``torch.Generator(device)`` seeded with
    ``req.seed``."""
    if req.x0 is not None:
        x0 = torch.as_tensor(req.x0).to(device=device, dtype=dtype)
        if tuple(x0.shape) != tuple(latent_shape):
            raise ValueError(f"request {req.rid}: x0 shape "
                             f"{tuple(x0.shape)} != latent {latent_shape}")
        return x0
    gen = torch.Generator(device=device).manual_seed(int(req.seed))
    return torch.randn(tuple(latent_shape), generator=gen, device=device,
                       dtype=dtype)


def _resolve_executor(drift, tgrid, n_steps, executor, use_kernel,
                      tracer=None, metrics=None) -> RoundExecutor:
    """Build an executor, or adopt the provided one (an explicit
    ``use_kernel`` that contradicts it raises)."""
    if executor is None:
        return RoundExecutor(drift, tgrid, n_steps,
                             use_kernel=bool(use_kernel), tracer=tracer,
                             metrics=metrics)
    if use_kernel is not None and bool(use_kernel) != executor.use_kernel:
        raise ValueError(
            f"use_kernel={use_kernel} conflicts with the provided "
            f"executor's use_kernel={executor.use_kernel}; configure the "
            f"flag on the RoundExecutor itself")
    return executor


class StreamingSampler:
    """Early-exit CHORDS sampler. ``batched=True`` treats axis 0 of ``x0``
    as independent requests with per-request accept state; ``live`` masks
    padding rows (born accepted)."""

    def __init__(self, drift, n_steps: int, num_cores: int, tgrid,
                 i_seq: Optional[Sequence[int]] = None, rtol: float = 0.05,
                 batched: bool = False,
                 executor: Optional[RoundExecutor] = None,
                 use_kernel: Optional[bool] = None, device="cuda"):
        self.device = resolve_device(device)
        self.n = n_steps
        self.k = num_cores
        self.tgrid = torch.as_tensor(tgrid).to(self.device)
        self.i_seq = list(i_seq) if i_seq is not None else make_sequence(
            num_cores, n_steps)
        self.rtol = rtol
        self.drift = drift
        self.batched = batched
        self.executor = _resolve_executor(drift, self.tgrid, n_steps,
                                          executor, use_kernel)
        self._run = self.executor.stream(StreamSpec(
            num_cores=num_cores, i_seq=tuple(self.i_seq), rtol=rtol,
            batched=batched))

    def sample(self, x0, live=None) -> SampleOut:
        x0 = torch.as_tensor(x0).to(self.device)
        req_shape = (x0.shape[0],) if self.batched else ()
        if live is None:
            live = torch.ones(req_shape, dtype=torch.bool, device=self.device)
        out, rounds, chosen = self._run(x0, torch.as_tensor(live).to(
            self.device))
        if self.batched:
            rounds = rounds.cpu().numpy()
            return SampleOut(out, rounds, chosen.cpu().numpy(),
                             self.n / np.maximum(1, rounds))
        rounds = int(rounds)
        return SampleOut(out, rounds, int(chosen), self.n / max(1, rounds))


class ChordsEngine:
    """Static-batch request server around the streaming sampler: a batch is
    held until its slowest request converges; partial batches are padded to
    ``max_batch`` with a live mask (one program ever)."""

    def __init__(self, drift_builder: Callable, latent_shape: tuple,
                 n_steps: int, num_cores: int, tgrid, max_batch: int = 8,
                 rtol: float = 0.05,
                 executor: Optional[RoundExecutor] = None,
                 use_kernel: Optional[bool] = None, device="cuda"):
        self.latent_shape = tuple(latent_shape)
        self.max_batch = max_batch
        self.sampler = StreamingSampler(drift_builder, n_steps, num_cores,
                                        tgrid, rtol=rtol, batched=True,
                                        executor=executor,
                                        use_kernel=use_kernel, device=device)
        self.device = self.sampler.device
        self.executor = self.sampler.executor
        self.queue: list[Request] = []
        self.stats = []

    def submit(self, req: Request):
        self.queue.append(req)

    def step(self) -> list[tuple[int, SampleOut]]:
        """Serve one batch from the queue; returns [(rid, SampleOut)]."""
        if not self.queue:
            return []
        batch, self.queue = (self.queue[: self.max_batch],
                             self.queue[self.max_batch:])
        pad = self.max_batch - len(batch)
        rows = [request_noise(r, self.latent_shape, self.device)
                for r in batch]
        noise = torch.stack(rows + [rows[0]] * pad)
        live = torch.tensor([True] * len(batch) + [False] * pad,
                            device=self.device)
        t0 = time.perf_counter()
        out = self.sampler.sample(noise, live=live)
        sample = out.sample.cpu()  # one transfer for the batch
        dt = time.perf_counter() - t0
        real = np.arange(len(batch))
        self.stats.append({"batch": len(batch), "padded": pad,
                           "rounds": int(np.max(out.rounds_used[real])),
                           "speedup": float(np.min(out.speedup[real])),
                           "wall_s": dt})
        return [(r.rid, SampleOut(sample[i], int(out.rounds_used[i]),
                                  int(out.accepted_core[i]),
                                  float(out.speedup[i])))
                for i, r in enumerate(batch)]

    def total_rounds(self) -> int:
        """Rounds-to-drain: static batches run back-to-back."""
        return int(sum(s["rounds"] for s in self.stats))


class ContinuousEngine:
    """Continuous-batching CHORDS runtime over a fixed ``[S, K, ...]`` slot
    grid (synchronous host loop).

    Every ``step()``: (1) the scheduling ``policy`` ('fifo' default, 'edf',
    'edf-preempt' or a Policy instance) decides admissions and evictions,
    applied with the masked in-place admission program; (2) one lockstep
    round for every live slot; (3) ``done``/``rounds_used``/``chosen`` come
    back in ONE device->host transfer (``host_syncs`` counts these) and
    finished slots drain, their results gathered in one more transfer.
    ``stats()`` has the reference's keys; the features not ported yet
    report their idle values.
    """

    def __init__(self, drift: Callable, latent_shape: tuple, n_steps: int,
                 num_cores: int, tgrid, num_slots: int = 4, rtol: float = 0.05,
                 priority_speedup: float = 1.25, policy=None,
                 aging_rounds: int = 32,
                 min_slots: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 overlap: bool = False,
                 lane_profile=None,
                 executor: Optional[RoundExecutor] = None,
                 use_kernel: Optional[bool] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda"):
        if overlap:
            raise _not_ported("ContinuousEngine(overlap=True)", 5,
                              "the overlap engine")
        if (min_slots not in (None, num_slots)
                or max_slots not in (None, num_slots)):
            raise _not_ported("elastic min_slots/max_slots", 6,
                              "elastic resize and migrate")
        if lane_profile:
            raise _not_ported("lane_profile", 7, "heterogeneous lanes")
        self.device = resolve_device(device)
        self.latent_shape = tuple(latent_shape)
        self.n = n_steps
        self.k = num_cores
        self.rtol = rtol
        self.priority_speedup = priority_speedup
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.policy = get_policy(policy)
        self.cost = CostModel(num_cores, n_steps,
                              priority_speedup=priority_speedup,
                              metrics=self.metrics)
        self.executor = _resolve_executor(
            drift, torch.as_tensor(tgrid).to(self.device), n_steps, executor,
            use_kernel, tracer=self.tracer, metrics=self.metrics)
        if self.executor.device != self.device:
            raise ValueError(f"executor runs on {self.executor.device}, "
                             f"engine on {self.device}")
        self.s = int(num_slots)
        self.spec = GridSpec(num_slots=self.s, num_cores=self.k,
                             latent_shape=self.latent_shape)
        self._prog = self.executor.grid(self.spec)
        self.state = self._prog.init_state()
        s = self.s
        self._slot_item: List[Optional[QueueItem]] = [None] * s
        self._slot_iseq: List[Optional[list]] = [None] * s
        self._slot_rtol = np.full((s,), self.rtol, np.float32)  # host mirror
        self._admit_round: List[int] = [0] * s
        self._admit_wall: List[float] = [0.0] * s
        self.queue = AdmissionQueue(aging_rounds=aging_rounds)
        self.round_count = 0
        self.preempted_rids: set = set()
        m = self.metrics
        m.gauge("serve.slots").set(float(s))
        self._c_host_syncs = m.counter("serve.host_syncs")
        self._c_preempt = m.counter("serve.preempt.count")
        self._c_preempt_wasted = m.counter("serve.preempt.rounds_wasted")
        self._c_deadline_total = m.counter("serve.deadline.total")
        self._c_deadline_misses = m.counter("serve.deadline.misses")
        self._c_live = m.counter("serve.occupancy.live_rounds")
        self._c_slot_rounds = m.counter("serve.occupancy.slot_rounds")
        self._c_wasted = m.counter("serve.occupancy.wasted_rounds")
        self._c_served = m.counter("serve.served")
        self._c_dispatches = m.counter("serve.dispatches")
        self._h_latency = m.histogram("serve.latency_rounds")
        self._h_speedup = m.histogram("serve.speedup")
        self._h_gap = m.histogram("serve.round_gap_s")
        m.gauge("serve.overlap").set(0.0)
        self._last_dispatch_done: Optional[float] = None
        self._submit_wall: Dict[int, float] = {}
        if self.tracer.enabled:
            for i in range(s):
                self.tracer.label_track(("slots", i), f"slot {i}")

    # -- host loop ------------------------------------------------------------

    @property
    def has_inflight(self) -> bool:
        """Any slot occupied (queued requests not included)."""
        return any(it is not None for it in self._slot_item)

    @property
    def host_syncs(self) -> int:
        """Done-flag readbacks; a read view over ``serve.host_syncs``."""
        return int(self._c_host_syncs.value)

    def submit(self, req: Request):
        self.queue.submit(req, priority=req.priority,
                          submit_round=self.round_count,
                          deadline_rounds=req.deadline_rounds,
                          rtol=self.rtol if req.rtol is None else req.rtol)
        if self.tracer.enabled:
            self._submit_wall[req.rid] = self.tracer.now()
            self.tracer.instant("request/submit", round_idx=self.round_count,
                                track=("requests", req.rid), rid=req.rid,
                                priority=req.priority)

    def _lane_views(self) -> list[LaneView]:
        """Host-side in-flight snapshot — no device sync: every live lane
        advances exactly one round per engine round."""
        lanes = []
        for slot, item in enumerate(self._slot_item):
            if item is None:
                continue
            done_r = self.round_count - self._admit_round[slot]
            lanes.append(LaneView(
                slot=slot, item=item, rounds_done=done_r,
                est_remaining=self.cost.remaining_rounds(
                    self._slot_iseq[slot], done_r, item.rtol),
                invested=done_r + item.rounds_credit))
        return lanes

    def _apply_decision(self, dec: Decision) -> None:
        """Apply a policy decision: evictions (re-queued with their rounds
        credited), then admissions through the masked admit program. The
        admitted requests' noise is drawn on the device."""
        now = self.round_count
        adm_slots = {a.slot for a in dec.admissions}
        if not all(s in adm_slots for s in dec.evictions):
            raise RuntimeError(f"eviction without admission: {dec}")
        for slot in dec.evictions:
            item = self._slot_item[slot]
            ran = now - self._admit_round[slot]
            item.rounds_credit += ran
            item.preemptions += 1
            self._c_preempt.inc()
            self._c_preempt_wasted.inc(ran)
            self._trace_evict(slot, item, ran, now)
            self.preempted_rids.add(item.payload.rid)
            self._slot_item[slot] = None
            self.queue.push(item)  # submit round/deadline/credit preserved
        if not dec.admissions:
            return
        mask = np.zeros(self.s, bool)
        i_arr = np.zeros((self.s, self.k), np.int32)
        x0 = torch.zeros((self.s,) + self.latent_shape, device=self.device)
        wall = self.tracer.now()
        for a in dec.admissions:
            mask[a.slot] = True
            i_arr[a.slot] = a.i_seq
            self._slot_rtol[a.slot] = a.item.rtol
            self._slot_item[a.slot] = a.item
            self._slot_iseq[a.slot] = list(a.i_seq)
            self._admit_round[a.slot] = now
            x0[a.slot] = request_noise(a.item.payload, self.latent_shape,
                                       self.device)
            self._trace_admit(a.slot, a.item, now, wall)
        t0 = self.tracer.now()
        dev = self.device
        self.state = self._prog.admit(
            self.state, torch.from_numpy(mask).to(dev), x0,
            torch.from_numpy(i_arr).to(dev),
            torch.from_numpy(self._slot_rtol).to(dev))
        self.tracer.span("dispatch/admit", t0, round_idx=now,
                         lanes=len(dec.admissions))

    def _trace_admit(self, slot: int, item: QueueItem, now: int,
                     wall: float) -> None:
        self._admit_wall[slot] = wall
        if not self.tracer.enabled:
            return
        rid = item.payload.rid
        t_q = self._submit_wall.pop(rid, None)
        if t_q is not None:
            self.tracer.span("request/queued", t_q, round_idx=now,
                             track=("requests", rid), t1=wall, rid=rid,
                             slot=slot)

    def _trace_evict(self, slot: int, item: QueueItem, ran: int,
                     now: int) -> None:
        if not self.tracer.enabled:
            return
        rid = item.payload.rid
        wall = self.tracer.now()
        self.tracer.span("request/compute", self._admit_wall[slot],
                         round_idx=now, track=("slots", slot), t1=wall,
                         rid=rid, preempted=True, rounds_ran=ran)
        self.tracer.instant("preempt", round_idx=now, rid=rid, slot=slot,
                            rounds_ran=ran)
        self._submit_wall[rid] = wall

    def _mark_dispatch(self, live: int) -> Tuple[float, object]:
        """Record the host gap since the previous dispatch returned (the
        time a busy grid waited for the host) and open a profiler range."""
        t = time.monotonic()
        if self._last_dispatch_done is not None:
            self._h_gap.observe(max(0.0, t - self._last_dispatch_done))
        self._c_dispatches.inc()
        rng = torch.profiler.record_function("dispatch/round")
        rng.__enter__()
        return self.tracer.now(), rng

    def _dispatch_done(self, t0: float, rng, live: int) -> None:
        rng.__exit__(None, None, None)
        self._last_dispatch_done = time.monotonic()
        if self.tracer.enabled:
            self.tracer.span("dispatch/round", t0, round_idx=self.round_count,
                             rounds=1, live=live)
            self.tracer.counter("occupancy", live)
            self.tracer.counter("queue_depth", len(self.queue))

    def _finish_lane(self, item: QueueItem, i_seq, ru: int, chosen_k: int,
                     sample, acc_round: int, slot: int = -1
                     ) -> tuple[int, SampleOut]:
        """Account one drained lane (latency is measured from submission)."""
        latency = acc_round - item.submit_round
        missed = False
        if math.isfinite(item.deadline_round):
            missed = acc_round > item.deadline_round
            self._c_deadline_total.inc()
            self._c_deadline_misses.inc(int(missed))
        res = SampleOut(sample=sample, rounds_used=ru,
                        accepted_core=chosen_k,
                        speedup=self.n / max(1, ru),
                        latency_rounds=latency)
        self.cost.observe_accept(i_seq, item.rtol, ru)
        self._c_served.inc()
        self._h_latency.observe(latency)
        self._h_speedup.observe(res.speedup)
        if self.tracer.enabled:
            rid = item.payload.rid
            self.tracer.span("request/compute", self._admit_wall[slot],
                             round_idx=acc_round, track=("slots", slot),
                             rid=rid, rounds_used=ru, core=chosen_k,
                             latency_rounds=latency)
            if missed:
                self.tracer.instant("deadline/miss", round_idx=acc_round,
                                    rid=rid, slot=slot,
                                    deadline=int(item.deadline_round),
                                    latency_rounds=latency)
            self._submit_wall.pop(rid, None)
        return (item.payload.rid, res)

    def step(self, max_rounds_on_device: int = 1
             ) -> list[tuple[int, SampleOut]]:
        """Policy decision -> one lockstep round -> drain. Returns finished
        requests as [(rid, SampleOut)]."""
        if int(max_rounds_on_device) > 1:
            raise _not_ported("max_rounds_on_device > 1", 8,
                              "the multi-round device loop")
        return self._step_sync()

    def _step_sync(self) -> list[tuple[int, SampleOut]]:
        free = [i for i, it in enumerate(self._slot_item) if it is None]
        if len(self.queue) and (free or self.policy.preemptive):
            view = EngineView(now=self.round_count, queue=self.queue,
                              free_slots=free, lanes=self._lane_views(),
                              cost=self.cost)
            self._apply_decision(self.policy.decide(view))
        if not self.has_inflight:
            self._last_dispatch_done = None  # gap timer: busy periods only
            return []

        live_ct = sum(it is not None for it in self._slot_item)
        t0, rng = self._mark_dispatch(live_ct)
        self.state = self._prog.round(self.state)
        self._dispatch_done(t0, rng, live_ct)
        t0 = self.tracer.now()
        flags = torch.stack((self.state.done.to(torch.int32),
                             self.state.rounds_used,
                             self.state.chosen)).cpu().numpy()  # ONE sync
        done, rounds_used, chosen = flags[0].astype(bool), flags[1], flags[2]
        self.tracer.span("verify/readback", t0, round_idx=self.round_count,
                         live=live_ct)
        self._c_host_syncs.inc()
        self.round_count += 1
        self._c_live.inc(live_ct)
        self._c_slot_rounds.inc(self.s)
        self._c_wasted.inc(self.s - live_ct)

        out: list[tuple[int, SampleOut]] = []
        drain = [slot for slot in range(self.s)
                 if self._slot_item[slot] is not None and done[slot]]
        if drain:
            # one gather + one transfer for the whole drain set
            idx = torch.as_tensor(drain, device=self.device)
            results = self.state.result[idx].cpu()
        for j, slot in enumerate(drain):
            item = self._slot_item[slot]
            out.append(self._finish_lane(
                item, self._slot_iseq[slot], int(rounds_used[slot]),
                int(chosen[slot]), results[j], acc_round=self.round_count,
                slot=slot))
            self._slot_item[slot] = None  # slot is free; done flag stays
            # until the next admission clears it (the lane is frozen)
        if not self.has_inflight:
            self._last_dispatch_done = None
        return out

    def run_until_drained(self, max_rounds: Optional[int] = None,
                          max_rounds_on_device: int = 1
                          ) -> list[tuple[int, SampleOut]]:
        """Step until queue and grid are empty; returns all (rid, SampleOut)."""
        budget = max_rounds if max_rounds is not None else \
            2 * (len(self.queue) + self.s) * (self.n + 1)  # 2x: preempt
        limit = self.round_count + budget
        served: list[tuple[int, SampleOut]] = []
        while len(self.queue) or self.has_inflight:
            served += self.step(max_rounds_on_device=max_rounds_on_device)
            if self.round_count >= limit \
                    and (len(self.queue) or self.has_inflight):
                raise RuntimeError(
                    f"engine did not drain within {budget} rounds")
        return served

    def stats(self) -> dict:
        """Throughput + latency percentiles in lockstep-round units, with
        the reference's keys (features not ported yet at their idle
        values)."""
        served = int(self._c_served.value)
        rounds = max(1, self.round_count)
        deadline_total = int(self._c_deadline_total.value)
        misses = int(self._c_deadline_misses.value)
        self.metrics.gauge("serve.rounds_total").set(float(self.round_count))
        self.metrics.gauge("serve.queue_depth").set(float(len(self.queue)))
        return {
            "served": served,
            "rounds_total": self.round_count,
            "throughput_req_per_round": served / rounds,
            "occupancy": (self._c_live.value
                          / max(1, self._c_slot_rounds.value)),
            "latency_rounds_p50": self._h_latency.percentile(50),
            "latency_rounds_p95": self._h_latency.percentile(95),
            "mean_speedup": self._h_speedup.mean,
            "policy": self.policy.name,
            "host_syncs": int(self._c_host_syncs.value),
            "overlap": False,
            "speculations": 0,
            "speculation_confirms": 0,
            "speculation_rollbacks": 0,
            "speculated_rounds_wasted": 0,
            "drain_lag_rounds": 0,
            "dispatches": int(self._c_dispatches.value),
            "round_gap_count": self._h_gap.count,
            "round_gap_mean_s": self._h_gap.mean,
            "round_gap_p95_s": self._h_gap.percentile(95),
            "round_gap_max_s": self._h_gap.max if self._h_gap.count else 0.0,
            "deadline_total": deadline_total,
            "deadline_misses": misses,
            "deadline_miss_rate": (misses / deadline_total
                                   if deadline_total else 0.0),
            "preemptions": int(self._c_preempt.value),
            "preempted_rounds_wasted": int(self._c_preempt_wasted.value),
            "num_slots": self.s,
            "min_slots": self.s,
            "max_slots": self.s,
            "wasted_slot_rounds": int(self._c_wasted.value),
            "resizes": 0,
            "grows": 0,
            "shrinks": 0,
            "resize_vetoes": 0,
            "migrations": 0,
            "buckets_visited": [self.s],
            "retraces": self.executor.retraces,
            "migration_traces": 0,
            "lane_modes_enabled": False,
            "lane_profile": [],
            "lane_skips": 0,
            "lane_served_nonexact": 0,
            "lane_promotes": 0,
            "lane_skip_rate": {m: self.cost.skip_rate(m)
                               for m in ("adaptive", "draft")},
            "kernel_path": self.executor.kernel_path,
            "accept_rounds_observed": self.cost.accept_table_json(),
        }

    def write_trace(self, path: str, meta: Optional[dict] = None) -> dict:
        raise _not_ported("write_trace (Chrome trace export)", 9,
                          "obs export/check")
