"""CHORDS serving runtimes — port of ``repro.serve.engine``.

``StreamingSampler`` runs Algorithm 1 and stops as soon as two consecutive
streamed outputs agree within rtol (paper Section 5). ``ChordsEngine`` is
the static-batch server around it: partial batches are padded to
``max_batch`` and a batch is held until its slowest request converges.
``ContinuousEngine`` serves a ``[S, K, ...]`` slot x core grid: every step
asks the scheduling policy which queued requests to admit (and, for
``edf-preempt``, which lanes to evict), runs one lockstep round for every
live slot, reads the done flags back in one transfer and drains finished
slots. With ``overlap=True`` the same contract is served by the
double-buffered speculative host loop: the next round is enqueued before
the previous round's flags are read, and while no lane is due to finish
nothing is read back at all. ``step(max_rounds_on_device=R)`` runs up to R
rounds as one device program: the synchronous loop leaves it at the first
accept (``multi``, one readback however many rounds ran), the overlap
loop's fast path rolls up to R rounds no lane can finish in (``roll``, no
readback). On CUDA each is one CUDA graph launch (``serve/graphs.py``).

Noise: a :class:`Request` carries ``seed`` — its init noise is drawn on the
engine's device from ``torch.Generator(device).manual_seed(seed)`` — or an
explicit ``x0``; the parity tests inject the JAX package's draws through
``x0`` (``jax.random`` streams cannot be reproduced in torch).

Elastic capacity (``min_slots < max_slots``) moves S along a power-of-two
bucket ladder, live lanes migrating between grids by a bit-exact masked
gather; every bucket's grid is built once, at construction, and kept.
Heterogeneous lanes (``lane_profile``) make each slot's K cores
asymmetric (draft lanes, stability-gated step skipping), opted into per
request through ``Request.mode``. ``write_trace`` exports the tracer's
events and the metrics snapshot as one Chrome trace-event JSON file in
the reference's schema (``python -m repro_torch.obs check``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.chords import default_lane_profile
from repro_torch.core.init_sequence import make_sequence
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.dist.sharding import is_dtensor, whole
from repro_torch.serve.executor import (GridSpec, RoundExecutor, StreamSpec,
                                        ambient_sharding_tag, read_rows)
from repro_torch.serve.sched.cost import CostModel
from repro_torch.serve.sched.policy import (Decision, EngineView, LaneView,
                                            ResizeProposal, get_policy)
from repro_torch.serve.sched.queue import AdmissionQueue, QueueItem


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
    mode: str = "exact"  # lane mode the request opts into: "exact"
    # (bitwise the homogeneous engine), "adaptive" (stability-gated step
    # skipping) or "draft" (skipping and coarse draft lanes). Honored only
    # by an engine built with a lane_profile; the policy may still upgrade
    # a non-exact request to exact when its deadline allows


def request_noise(req: Request, latent_shape, device,
                  dtype=torch.float32) -> torch.Tensor:
    """The request's init noise on ``device``: ``req.x0`` when given, else
    a standard normal draw from ``torch.Generator(device)`` seeded with
    ``req.seed``."""
    if req.x0 is not None:
        x0 = torch.as_tensor(req.x0)
        if tuple(x0.shape) != tuple(latent_shape):
            raise ValueError(f"request {req.rid}: x0 shape "
                             f"{tuple(x0.shape)} != latent {latent_shape}")
        return _to_device(x0.to(dtype), device)
    gen = torch.Generator(device=device).manual_seed(int(req.seed))
    return torch.randn(tuple(latent_shape), generator=gen, device=device,
                       dtype=dtype)


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without blocking the host: a CUDA copy
    is staged through pinned memory and enqueued on the current stream
    (the caching host allocator keeps the staging block until the copy has
    run)."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
    padding rows (born accepted).

    The program is the JAX package's stream loop on the device
    (``RoundExecutor.stream``): on the card one CUDA graph launch a call,
    and ``sample`` reads back once (``rounds`` and ``chosen`` together,
    and with ``host=True`` the samples too). ``host_readbacks`` counts the
    host's waits for the device: one a call on the graph path, one more a
    round on the eager one (its loop condition)."""

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
            batched=batched, sharding=ambient_sharding_tag()))
        self._readbacks = 0

    @property
    def program(self):
        """The stream program (``EagerStream`` or ``GraphStream``)."""
        return self._run

    @property
    def host_readbacks(self) -> int:
        return self._readbacks + self._run.readbacks

    def _to_host(self, *ts):
        """Copy ``ts`` to the host with one wait for the device."""
        self._readbacks += 1
        if self.device.type != "cuda":
            return [t.clone() for t in ts]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        for h, t in zip(host, ts):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return host

    def sample(self, x0, live=None, host: bool = False) -> SampleOut:
        """One call of the stream program. ``host=True`` returns the
        samples on the host, read back with ``rounds`` and ``chosen``."""
        x0 = torch.as_tensor(x0).to(self.device)
        req_shape = (x0.shape[0],) if self.batched else ()
        if live is None:
            live = torch.ones(req_shape, dtype=torch.bool, device=self.device)
        out, rc = self._run(x0, torch.as_tensor(live).to(self.device))
        if host:
            out, rc = self._to_host(out, rc)
        else:
            (rc,) = self._to_host(rc)
        rounds, chosen = rc.numpy()
        if self.batched:
            return SampleOut(out, rounds, chosen,
                             self.n / np.maximum(1, rounds))
        rounds = int(rounds)
        return SampleOut(out, rounds, int(chosen), self.n / max(1, rounds))


class ChordsEngine:
    """Static-batch request server around the streaming sampler: a batch is
    held until its slowest request converges; partial batches are padded to
    ``max_batch`` with a live mask (one program ever: on the card one CUDA
    graph, one launch and one readback a batch)."""

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
        out = self.sampler.sample(noise, live=live, host=True)
        sample = out.sample  # on the host: one readback for the batch
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


@dataclasses.dataclass
class _DecisionUndo:
    """Host-side inverse of one speculatively applied :class:`Decision`.

    The device side of a rollback is the engine reinstating the
    pre-decision ``SlotState`` it kept (``GridPrograms.keep``: a device
    copy on the graph path, whose programs write their state in place; the
    state itself on the eager path, whose programs never write their
    inputs). This record undoes the *host* effects: queue membership,
    preemption credit and counters, and the per-slot mirrors.
    """

    admissions: List[tuple]          # (slot, item) admitted -> re-queue
    evictions: List[tuple]           # (slot, item, ran) evicted -> restore
    prior: Dict[int, tuple]          # slot -> mirror tuple before the decision
    preempted_new: List[int]         # rids first marked preempted here


def bucket_ladder(min_slots: int, max_slots: int) -> List[int]:
    """Power-of-two capacity buckets from ``min_slots`` up to ``max_slots``
    (the top bucket is clamped to ``max_slots`` even off-ladder)."""
    if min_slots < 1 or min_slots > max_slots:
        raise ValueError(f"need 1 <= min_slots <= max_slots, got "
                         f"{min_slots}..{max_slots}")
    b, out = min_slots, [min_slots]
    while b < max_slots:
        b = min(b * 2, max_slots)
        out.append(b)
    return out


class ContinuousEngine:
    """Continuous-batching CHORDS runtime over a demand-paged ``[S, K, ...]``
    slot grid.

    Every ``step()``: (0) with elastic capacity, maybe resize the grid;
    (1) the scheduling ``policy`` ('fifo' default, 'edf', 'edf-preempt' or
    a Policy instance) decides admissions and evictions, applied with the
    masked in-place admission program; (2) one lockstep round for every
    live slot; (3) ``done``/``rounds_used``/``chosen`` come back in ONE
    device->host transfer (``host_syncs`` counts these) and finished slots
    drain, their results gathered in one more transfer.

    **Elastic capacity** (``min_slots < max_slots``): S moves along the
    power-of-two bucket ladder. Growth is immediate when queued demand
    exceeds free capacity (to the smallest bucket that fits live + queued;
    never vetoed). Shrinking waits until occupancy has fit the next bucket
    down for ``resize_hysteresis`` consecutive rounds, and the policy may
    veto it (``Policy.consider_resize``). Live lanes migrate to the new
    grid by a masked gather that copies each lane bit-exactly
    (``executor.migrate``), so a resize never changes a result. Every
    bucket's grid (on CUDA: its graphs and state buffers) is built once at
    construction and pinned in the executor's cache; ``retraces`` is the
    ladder's length. ``min_slots == max_slots`` (the default) is the
    fixed-S engine bit for bit.

    **Heterogeneous lanes** (``lane_profile``: a tuple of
    ``core.chords.LaneSpec``, or ``True``/``"default"`` for
    ``default_lane_profile(K)``): trailing cores take a draft role and/or
    stability-gated step skipping; requests opt in through
    ``Request.mode`` ("exact" | "adaptive" | "draft"), which the cost model
    prices and the policy may upgrade to exact. An exact request zeroes
    every gate, so its output is bitwise the homogeneous engine's;
    ``lane_skip_tau`` is the skip threshold of the non-exact modes.

    ``step(max_rounds_on_device=R)`` amortizes the host over up to R rounds
    (:meth:`_step_sync`, :meth:`_step_overlap`) with the same samples and
    schedule as R = 1.

    ``overlap=True`` serves the same contract with the double-buffered
    speculative loop (:meth:`_step_overlap`); its samples, rounds and
    latencies are bitwise those of the synchronous loop whenever its
    speculation is confirmed, and after every rollback too.
    ``guard_syncs=True`` (CUDA only, a debug check) runs the host's work
    between speculating and verifying, and the fast path's dispatch, under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing call
    there raises. ``stats()`` has the reference's keys, and
    ``programs`` (graph or eager).
    """

    def __init__(self, drift: Callable, latent_shape: tuple, n_steps: int,
                 num_cores: int, tgrid, num_slots: int = 4, rtol: float = 0.05,
                 priority_speedup: float = 1.25, policy=None,
                 aging_rounds: int = 32,
                 min_slots: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 resize_hysteresis: int = 8,
                 overlap: bool = False,
                 lane_profile=None,
                 lane_skip_tau: float = 0.4,
                 executor: Optional[RoundExecutor] = None,
                 use_kernel: Optional[bool] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 guard_syncs: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.latent_shape = tuple(latent_shape)
        self.n = n_steps
        self.k = num_cores
        self.rtol = rtol
        self.priority_speedup = priority_speedup
        self.overlap = bool(overlap)
        self.guard_syncs = bool(guard_syncs)
        # a lane profile makes the K cores asymmetric; None keeps the
        # homogeneous engine (every request runs exact, Request.mode is
        # ignored, the programs are unchanged)
        if lane_profile is True or lane_profile == "default":
            lane_profile = default_lane_profile(num_cores)
        self.lane_profile = tuple(lane_profile) if lane_profile else None
        self.lane_skip_tau = float(lane_skip_tau)
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
        if min_slots is None and max_slots is None:
            self.min_slots = self.max_slots = int(num_slots)
        else:
            self.min_slots = int(min_slots if min_slots is not None
                                 else num_slots)
            self.max_slots = int(max_slots if max_slots is not None
                                 else max(num_slots, self.min_slots))
        self._ladder = bucket_ladder(self.min_slots, self.max_slots)
        # the ambient mesh context is part of the cache key: a program
        # built under use_sharding is never served to a bare engine (every
        # bucket's grid is built now, under the context of construction)
        self._sharding = ambient_sharding_tag()
        # every bucket's grid is built now, once, and pinned: a graph grid
        # captures in 0.2-0.8 s, so a resize must never rebuild one, and no
        # eviction may take a grid with live lanes or a migration source
        self.executor.reserve_grid_capacity(len(self._ladder))
        self._progs = {b: self.executor.pin(self._spec(b))
                       for b in self._ladder}
        for p in self._progs.values():
            p.init_state()  # a graph grid's buffers now serve this engine
        # the overlap loop's readback lands in pinned host buffers, one set
        # per bucket: flags [3 or 4, S] (done, rounds_used, chosen and, on
        # a lane grid, the lanes' skips) and the due lanes' results, copied
        # without blocking the host
        self._rb: Dict[int, tuple] = {}
        if self.overlap and self.device.type == "cuda":
            rows = 3 + (self.lane_profile is not None)
            for b in self._ladder:
                self._rb[b] = (
                    torch.empty((rows, b), dtype=torch.int32,
                                pin_memory=True),
                    torch.empty((b,) + self.latent_shape, pin_memory=True))
        self.resize_hysteresis = max(1, int(resize_hysteresis))
        self._install_grid(self._ladder[0])  # demand-paged: start smallest
        self._buckets_visited = {self.s}
        self.queue = AdmissionQueue(aging_rounds=aging_rounds)
        self.round_count = 0  # plain attribute: trace drivers write it
        self.preempted_rids: set = set()
        self.migrated_rids: set = set()  # rids whose lane crossed a resize
        self._low_streak = 0  # consecutive rounds of shrinkable occupancy
        m = self.metrics
        self._c_host_syncs = m.counter("serve.host_syncs")
        self._c_preempt = m.counter("serve.preempt.count")
        self._c_preempt_wasted = m.counter("serve.preempt.rounds_wasted")
        self._c_deadline_total = m.counter("serve.deadline.total")
        self._c_deadline_misses = m.counter("serve.deadline.misses")
        self._c_live = m.counter("serve.occupancy.live_rounds")
        self._c_slot_rounds = m.counter("serve.occupancy.slot_rounds")
        self._c_wasted = m.counter("serve.occupancy.wasted_rounds")
        self._c_resizes = m.counter("serve.resize.count")
        self._c_grows = m.counter("serve.resize.grows")
        self._c_shrinks = m.counter("serve.resize.shrinks")
        self._c_vetoes = m.counter("serve.resize.vetoes")
        self._c_migrations = m.counter("serve.resize.migrations")
        self._c_served = m.counter("serve.served")
        self._c_spec = m.counter("serve.spec.count")
        self._c_spec_confirms = m.counter("serve.spec.confirms")
        self._c_spec_rollbacks = m.counter("serve.spec.rollbacks")
        self._c_spec_wasted = m.counter("serve.spec.rounds_wasted")
        self._c_drain_lag = m.counter("serve.drain_lag_rounds")
        self._c_dispatches = m.counter("serve.dispatches")
        # heterogeneous-lane accounting (all zero on a homogeneous grid)
        self._c_lane_skips = m.counter("serve.lanes.skips")
        self._c_lane_nonexact = m.counter("serve.lanes.served_nonexact")
        self._c_lane_promotes = m.counter("serve.lanes.promotes")
        self._h_latency = m.histogram("serve.latency_rounds")
        self._h_speedup = m.histogram("serve.speedup")
        self._h_gap = m.histogram("serve.round_gap_s")
        m.gauge("serve.overlap").set(float(self.overlap))
        self._last_dispatch_done: Optional[float] = None
        self._submit_wall: Dict[int, float] = {}

    # -- grid management ------------------------------------------------------

    def _spec(self, s: int) -> GridSpec:
        return GridSpec(num_slots=s, num_cores=self.k,
                        latent_shape=self.latent_shape,
                        lane_profile=self.lane_profile,
                        sharding=self._sharding)

    def _install_grid(self, s: int):
        """Make bucket ``s`` the current grid, at its initial state
        (construction, or a resize: the previous grid's buffers are left
        alone, so a migration can still read them)."""
        self.s = s
        self.spec = self._spec(s)
        self._prog = self._progs[s]
        self.state = self._prog.reset()
        self._slot_item: List[Optional[QueueItem]] = [None] * s
        self._slot_iseq: List[Optional[list]] = [None] * s
        self._slot_rtol = np.full((s,), self.rtol, np.float32)  # host mirror
        self._admit_round: List[int] = [0] * s
        # cost-model prediction of the absolute round each lane accepts:
        # the overlap loop's speculation horizon (None = slot free)
        self._pred_done: List[Optional[int]] = [None] * s
        # wall clock of each lane's committed admission: the start of its
        # request/compute span on the per-slot trace track
        self._admit_wall: List[float] = [0.0] * s
        # lane mode each slot's resident request runs under (meaningful
        # only while the slot is occupied; admissions overwrite it)
        self._slot_mode: List[str] = ["exact"] * s
        self.metrics.gauge("serve.slots").set(float(s))
        if self.tracer.enabled:
            suffix = ""
            if self.lane_profile is not None:
                # D = draft, A = skip-only, R = refine
                roles = "".join(
                    "D" if sp.role == "draft" else
                    ("A" if sp.skip else "R") for sp in self.lane_profile)
                suffix = f" [{roles}]"
            for i in range(s):
                self.tracer.label_track(("slots", i), f"slot {i}{suffix}")

    def _resize_to(self, new_s: int):
        """Move the grid to capacity ``new_s``, migrating live lanes: every
        migrated lane's carry and accept state is copied bit-exactly into
        the lowest-indexed destination lanes (``executor.migrate``, on the
        current stream after any round in flight on the old grid), so
        in-flight requests cannot observe the resize."""
        occupied = [i for i, it in enumerate(self._slot_item)
                    if it is not None]
        if len(occupied) > new_s:
            raise RuntimeError(f"{len(occupied)} live lanes do not fit "
                               f"{new_s} slots")
        old_s, old_spec, old_state = self.s, self.spec, self.state
        old = (self._slot_item, self._slot_iseq, self._slot_rtol,
               self._admit_round, self._pred_done, self._admit_wall,
               self._slot_mode)
        t_mig = self.tracer.now()
        self._install_grid(new_s)
        if occupied:
            host = np.zeros((2, new_s), np.int32)  # mask, source lane
            for dst, s_old in enumerate(occupied):
                host[0, dst], host[1, dst] = 1, s_old
                self._slot_item[dst] = old[0][s_old]
                self._slot_iseq[dst] = old[1][s_old]
                self._slot_rtol[dst] = old[2][s_old]
                self._admit_round[dst] = old[3][s_old]
                self._pred_done[dst] = old[4][s_old]
                self._slot_mode[dst] = old[6][s_old]
                self.migrated_rids.add(old[0][s_old].payload.rid)
                # a migration ends the lane's residency on the old slot
                # track and opens one on the destination: per-slot compute
                # spans stay nest-or-disjoint across the renumbering
                self.tracer.span("request/compute", old[5][s_old],
                                 round_idx=self.round_count,
                                 track=("slots", s_old), t1=t_mig,
                                 rid=old[0][s_old].payload.rid,
                                 migrated=True)
                self._admit_wall[dst] = t_mig
            self._c_migrations.inc(len(occupied))
            t0 = self.tracer.now()
            dev = _to_device(torch.from_numpy(host), self.device)
            self.state = self.executor.migrate(old_spec, self.spec)(
                self.state, old_state, dev[0] != 0, dev[1])
            self.tracer.span("dispatch/migrate", t0,
                             round_idx=self.round_count, lanes=len(occupied))
            self.tracer.instant("migrate/lanes", round_idx=self.round_count,
                                lanes=len(occupied), src=old_s, dst=new_s)
        self._c_resizes.inc()
        self.tracer.instant("resize/grow" if new_s > old_s else
                            "resize/shrink", round_idx=self.round_count,
                            src=old_s, dst=new_s, live=len(occupied))
        self._buckets_visited.add(new_s)

    def _next_lower_bucket(self) -> Optional[int]:
        i = self._ladder.index(self.s)
        return self._ladder[i - 1] if i > 0 else None

    def _maybe_resize(self):
        """Demand paging: grow on queued demand, shrink on sustained idle."""
        if self.min_slots == self.max_slots:
            return
        live_ct = sum(it is not None for it in self._slot_item)
        if len(self.queue) > self.s - live_ct and self.s < self.max_slots:
            demand = live_ct + len(self.queue)
            target = self.s
            for b in self._ladder:
                if b > self.s:
                    target = b
                    if b >= demand:
                        break
            self._resize_to(target)  # growth is never vetoed
            self._c_grows.inc()
            self._low_streak = 0
            return
        lower = self._next_lower_bucket()
        if lower is None or live_ct > lower \
                or self._low_streak < self.resize_hysteresis:
            return
        # queued work does not block the proposal: whether the smaller grid
        # can still serve it (deadlines included) is the policy's call
        proposal = ResizeProposal(current_slots=self.s, new_slots=lower,
                                  live_lanes=live_ct, queued=len(self.queue))
        view = self._view([i for i, it in enumerate(self._slot_item)
                           if it is None])
        if self.policy.consider_resize(view, proposal) is None:
            self._c_vetoes.inc()
            self.tracer.instant("resize/veto", round_idx=self.round_count,
                                src=self.s, dst=lower, live=live_ct,
                                queued=len(self.queue))
            self._low_streak = 0  # re-arm: ask again after a full window
            return
        self._resize_to(lower)
        self._c_shrinks.inc()
        self._low_streak = 0

    def _update_streak(self, live_before: int, live_after: int, ran: int):
        """Shrink hysteresis in device-round units, for both host loops.

        ``ran`` rounds are credited when occupancy fit the next bucket down
        for the whole step (``live_before``, after admission, and
        ``live_after``, after the drain, both within it). A step during
        which occupancy dropped into range credits exactly one round
        whatever ``ran``: the multi-round loop exits on the accept that
        freed the lane, so only the chunk's last round ran at the lower
        occupancy. ``ran == 0`` (an overlap verify-only step) changes
        nothing."""
        lower = self._next_lower_bucket()
        if lower is None or live_after > lower:
            self._low_streak = 0
        elif live_before <= lower:
            self._low_streak += ran
        elif ran > 0:
            self._low_streak = 1

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
                    self._slot_iseq[slot], done_r, item.rtol,
                    mode=self._slot_mode[slot]),
                invested=done_r + item.rounds_credit))
        return lanes

    def _view(self, free, now: Optional[int] = None, lanes=None,
              speculative: bool = False) -> EngineView:
        """The policy's view of the engine at round ``now`` (default: the
        current round) with ``free`` slots and ``lanes`` in flight
        (default: every occupied slot)."""
        return EngineView(now=self.round_count if now is None else now,
                          queue=self.queue, free_slots=free,
                          lanes=self._lane_views() if lanes is None
                          else lanes, cost=self.cost,
                          speculative=speculative,
                          lane_modes=self.lane_profile is not None)

    def _apply_decision(self, dec: Decision, now: Optional[int] = None,
                        record_undo: bool = False
                        ) -> Optional[_DecisionUndo]:
        """Apply a policy decision (evictions, re-queued with their rounds
        credited, then admissions through the masked admit program) at
        round ``now`` (default: the current round). The admitted requests'
        noise is drawn on the device; the slot mask, init sequences and
        tolerances (and, on a lane grid, the gates of each admitted
        request's lane mode) go up in one copy staged through pinned
        memory, so an admission never blocks the host.

        ``record_undo=True`` returns a :class:`_DecisionUndo` that reverses
        every host-side effect (the overlap loop applies decisions
        speculatively) and defers the decision's trace events to the
        commit point."""
        now = self.round_count if now is None else now
        adm_slots = {a.slot for a in dec.admissions}
        if not all(s in adm_slots for s in dec.evictions):
            raise RuntimeError(f"eviction without admission: {dec}")
        undo = _DecisionUndo([], [], {}, []) if record_undo else None
        if record_undo:
            for slot in set(dec.evictions) | adm_slots:
                undo.prior[slot] = (
                    self._slot_item[slot], self._slot_iseq[slot],
                    float(self._slot_rtol[slot]), self._admit_round[slot],
                    self._pred_done[slot], self._admit_wall[slot],
                    self._slot_mode[slot])
        for slot in dec.evictions:
            item = self._slot_item[slot]
            ran = now - self._admit_round[slot]
            item.rounds_credit += ran
            item.preemptions += 1
            self._c_preempt.inc()
            self._c_preempt_wasted.inc(ran)
            if record_undo:
                undo.evictions.append((slot, item, ran))
                if item.payload.rid not in self.preempted_rids:
                    undo.preempted_new.append(item.payload.rid)
            else:
                self._trace_evict(slot, item, ran, now,
                                  self._admit_wall[slot])
            self.preempted_rids.add(item.payload.rid)
            self._slot_item[slot] = None
            self._pred_done[slot] = None
            self.queue.push(item)  # submit round/deadline/credit preserved
        if not dec.admissions:
            return undo
        # one host array: mask, the init sequences and the f32 tolerances'
        # bits, as int32 columns [S, 1 + K + 1]; a lane grid adds each
        # admitted request's gates: draft_on and the skip threshold's bits
        hetero = self.lane_profile is not None
        kk = self.k
        host = np.zeros((self.s, kk + 2 + 2 * hetero), np.int32)
        x0 = torch.zeros((self.s,) + self.latent_shape, device=self.device)
        wall = self.tracer.now()
        for a in dec.admissions:
            host[a.slot, 0] = 1
            host[a.slot, 1:kk + 1] = a.i_seq
            self._slot_rtol[a.slot] = a.item.rtol
            self._slot_item[a.slot] = a.item
            self._slot_iseq[a.slot] = list(a.i_seq)
            self._admit_round[a.slot] = now
            self._admit_wall[a.slot] = wall
            # the policy's Admission.mode, honored only by a lane grid: a
            # homogeneous one runs (and prices) everything exact
            mode = a.mode if hetero else "exact"
            self._slot_mode[a.slot] = mode
            self._pred_done[a.slot] = self.cost.predict_done_round(
                a.i_seq, a.item.rtol, now, mode=mode)
            if hetero:
                # draft lanes smooth only in "draft"; skipping arms in both
                # non-exact modes; "exact" zeroes both gates, so every
                # lane-masked select picks the exact operand bitwise
                host[a.slot, kk + 2] = mode == "draft"
                host[a.slot, kk + 3] = np.float32(
                    self.lane_skip_tau if mode in ("draft", "adaptive")
                    else 0.0).view(np.int32)
            x0[a.slot] = request_noise(a.item.payload, self.latent_shape,
                                       self.device)
            if record_undo:
                undo.admissions.append((a.slot, a.item))
            else:
                self._trace_admit(a.slot, a.item, now, wall)
        host[:, kk + 1] = self._slot_rtol.view(np.int32)
        t0 = self.tracer.now()
        dev = _to_device(torch.from_numpy(host), self.device)
        gates = ((dev[:, kk + 2] != 0, dev[:, kk + 3].view(torch.float32))
                 if hetero else ())
        self.state = self._prog.admit(
            self.state, dev[:, 0] != 0, x0, dev[:, 1:kk + 1],
            dev[:, kk + 1].view(torch.float32), *gates)
        self.tracer.span("dispatch/admit", t0, round_idx=now,
                         lanes=len(dec.admissions))
        return undo

    # -- commit-point trace emission ------------------------------------------
    # Speculatively applied decisions emit nothing (record_undo=True); their
    # events are emitted at confirmation (:meth:`_trace_commit_undo`) or by
    # the committed re-decide after a rollback, so a rolled-back admission
    # never leaves lifecycle events in the trace.

    def _trace_admit(self, slot: int, item: QueueItem, now: int,
                     wall: float) -> None:
        """Close the request's queued span and (re)open its residency."""
        self._admit_wall[slot] = wall
        if not self.tracer.enabled:
            return
        rid = item.payload.rid
        t_q = self._submit_wall.pop(rid, None)
        if t_q is not None:
            self.tracer.span("request/queued", t_q, round_idx=now,
                             track=("requests", rid), t1=wall, rid=rid,
                             slot=slot)

    def _trace_evict(self, slot: int, item: QueueItem, ran: int, now: int,
                     admit_wall: float) -> None:
        """A committed eviction ends the residency span and re-opens the
        request's queued span (evict-requeue)."""
        if not self.tracer.enabled:
            return
        rid = item.payload.rid
        wall = self.tracer.now()
        self.tracer.span("request/compute", admit_wall, round_idx=now,
                         track=("slots", slot), t1=wall, rid=rid,
                         preempted=True, rounds_ran=ran)
        self.tracer.instant("preempt", round_idx=now, rid=rid, slot=slot,
                            rounds_ran=ran)
        self._submit_wall[rid] = wall

    def _trace_commit_undo(self, undo: Optional[_DecisionUndo],
                           now: int) -> None:
        """Emit the lifecycle events of a speculative decision the verify
        readback just confirmed, after the due drains (so the replaced
        residents' spans close before the new residents' open)."""
        if undo is None or not self.tracer.enabled:
            return
        for slot, item, ran in undo.evictions:
            self._trace_evict(slot, item, ran, now, undo.prior[slot][5])
        wall = self.tracer.now()
        for slot, item in undo.admissions:
            self._trace_admit(slot, item, now, wall)

    def _undo_decision(self, undo: _DecisionUndo) -> None:
        """Reverse the host side of a speculatively applied decision (the
        device side is the caller reinstating the retained pre-decision
        state). Queue order is computed from item keys at every pop, so the
        push/remove round trips cannot perturb the survivors' order."""
        for _slot, item in undo.admissions:
            self.queue.push(item)  # popped by policy.decide: re-enqueue
        for _slot, item, ran in undo.evictions:
            self.queue.remove(item)
            item.rounds_credit -= ran
            item.preemptions -= 1
            self._c_preempt.inc(-1)  # negative inc: speculative-undo path
            self._c_preempt_wasted.inc(-ran)
        for rid in undo.preempted_new:
            self.preempted_rids.discard(rid)
        for slot, prior in undo.prior.items():
            (self._slot_item[slot], self._slot_iseq[slot], rtol,
             self._admit_round[slot], self._pred_done[slot],
             self._admit_wall[slot], self._slot_mode[slot]) = prior
            self._slot_rtol[slot] = rtol

    def _amortizable(self) -> bool:
        """May the host stay away for several rounds? Yes when nothing it
        could do between rounds matters: the queue is empty, or every slot
        is busy and the policy never preempts (then the next admission
        opportunity IS the next accept, which exits the device loop)."""
        if len(self.queue) == 0:
            return True
        if self.policy.preemptive:
            return False  # preemption decisions are made between rounds
        return not any(it is None for it in self._slot_item)

    # -- round-gap timer ------------------------------------------------------

    def _dispatch(self, live: int, kind: str = "round", rounds: int = 1):
        """Enqueue the grid program ``kind`` (``round``, or ``roll`` /
        ``multi`` with a budget of ``rounds``) on the current state and
        return what it returns, inside a profiler range
        ``dispatch/<kind>``, counted in ``serve.dispatches.<kind>``.
        Records the host gap since the previous
        dispatch returned: PyTorch enqueues asynchronously, so this times
        the host's enqueue, not the device's completion; it is the time a
        busy grid waited for the host only when the device had run dry. The
        device idle share comes from the profiler, not from this timer."""
        t = time.monotonic()
        gap = {}
        if self._last_dispatch_done is not None:
            gap["gap_s"] = max(0.0, t - self._last_dispatch_done)
            self._h_gap.observe(gap["gap_s"])
        self._c_dispatches.inc()
        self.metrics.counter(f"serve.dispatches.{kind}").inc()
        t0 = self.tracer.now()
        prog = getattr(self._prog, kind)
        with torch.profiler.record_function(f"dispatch/{kind}"):
            out = prog(self.state) if kind == "round" \
                else prog(self.state, rounds)
        self._last_dispatch_done = time.monotonic()
        if self.tracer.enabled:
            # each dispatch span carries its own host gap, so the round-gap
            # contract is checkable from the trace alone (obs check)
            self.tracer.span(f"dispatch/{kind}", t0,
                             round_idx=self.round_count, rounds=rounds,
                             live=live, **gap)
            self.tracer.counter("occupancy", live)
            self.tracer.counter("queue_depth", len(self.queue))
        return out

    def _finish_lane(self, item: QueueItem, i_seq, ru: int, chosen_k: int,
                     sample, acc_round: int, slot: int = -1,
                     admit_wall: float = 0.0, mode: str = "exact",
                     skips: int = 0) -> tuple[int, SampleOut]:
        """Account one drained lane. ``acc_round`` is the absolute engine
        round at which the accept fired: ``round_count`` at the drain in
        the synchronous loop, ``admit_round + rounds_used`` in the overlap
        loop (the same number, whenever the host discovers the accept).
        Latency is measured from submission. This drain commit is the only
        place the lane instants (``lane/skip``, ``lane/promote``) are
        emitted, so a rolled-back speculative step leaves none."""
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
        self.cost.observe_accept(i_seq, item.rtol, ru, mode=mode)
        self.cost.observe_skips(mode, skips, ru)
        self._c_served.inc()
        self._c_lane_skips.inc(skips)
        promoted = (self.lane_profile is not None
                    and 0 <= chosen_k < len(self.lane_profile)
                    and self.lane_profile[chosen_k].role == "draft")
        if mode != "exact":
            self._c_lane_nonexact.inc()
        if promoted:
            self._c_lane_promotes.inc()
        self._h_latency.observe(latency)
        self._h_speedup.observe(res.speedup)
        if self.tracer.enabled:
            rid = item.payload.rid
            self.tracer.span("request/compute", admit_wall,
                             round_idx=acc_round, track=("slots", slot),
                             rid=rid, rounds_used=ru, core=chosen_k,
                             latency_rounds=latency)
            if skips > 0:
                self.tracer.instant("lane/skip", round_idx=acc_round,
                                    track=("slots", slot), rid=rid,
                                    count=skips, mode=mode)
            if promoted:
                self.tracer.instant("lane/promote", round_idx=acc_round,
                                    track=("slots", slot), rid=rid,
                                    core=chosen_k, mode=mode)
            if missed:
                self.tracer.instant("deadline/miss", round_idx=acc_round,
                                    rid=rid, slot=slot,
                                    deadline=int(item.deadline_round),
                                    latency_rounds=latency)
            self._submit_wall.pop(rid, None)
        return (item.payload.rid, res)

    def step(self, max_rounds_on_device: int = 1
             ) -> list[tuple[int, SampleOut]]:
        """Resize check -> policy decision -> lockstep round(s) -> drain.
        Returns finished
        requests as [(rid, SampleOut)]; with ``overlap=True`` through the
        speculative loop (:meth:`_step_overlap`). ``max_rounds_on_device``
        R > 1 lets one device program run up to R rounds."""
        if self.overlap:
            return self._step_overlap(max_rounds_on_device)
        return self._step_sync(max_rounds_on_device)

    def _count_rounds(self, live_ct: int, ran: int = 1) -> None:
        self._c_live.inc(live_ct * ran)
        self._c_slot_rounds.inc(self.s * ran)
        self._c_wasted.inc((self.s - live_ct) * ran)

    def _flags(self, st):
        """The [3 or 4, S] int32 flags of ``st``: done, rounds_used, chosen
        and, on a lane grid, each slot's committed skips."""
        rows = [st.done.to(torch.int32), st.rounds_used, st.chosen]
        if self.lane_profile is not None:
            rows.append(st.lanes.skips.sum(dim=1, dtype=torch.int32))
        return torch.stack([whole(r) for r in rows])

    def _step_sync(self, max_rounds_on_device: int = 1
                   ) -> list[tuple[int, SampleOut]]:
        self._maybe_resize()
        free = [i for i, it in enumerate(self._slot_item) if it is None]
        if len(self.queue) and (free or self.policy.preemptive):
            self._apply_decision(self.policy.decide(self._view(free)))
        if not self.has_inflight:
            # a fully idle grid is the lowest occupancy there is: idle steps
            # count toward the shrink hysteresis, so a drained engine still
            # pages its slots out (each idle step ~ one round)
            if self.min_slots != self.max_slots and not len(self.queue):
                self._low_streak += 1
            self._last_dispatch_done = None  # gap timer: busy periods only
            return []

        live_ct = sum(it is not None for it in self._slot_item)
        r_dev = max(1, int(max_rounds_on_device))
        if r_dev > 1 and self._amortizable():
            self.state, ran_dev = self._dispatch(live_ct, "multi", r_dev)
        else:
            self.state, ran_dev = self._dispatch(live_ct), None
        t0 = self.tracer.now()
        flags = self._flags(self.state).reshape(-1)
        if ran_dev is not None:
            flags = torch.cat((flags, ran_dev.reshape(1)))
        flags = flags.cpu().numpy()  # ONE sync
        ran = int(flags[-1]) if ran_dev is not None else 1
        s = self.s
        done = flags[:s].astype(bool)
        rounds_used, chosen = flags[s:2 * s], flags[2 * s:3 * s]
        skips = flags[3 * s:4 * s] if self.lane_profile is not None else None
        self.tracer.span("verify/readback", t0, round_idx=self.round_count,
                         live=live_ct)
        self._c_host_syncs.inc()
        self.round_count += ran
        self._count_rounds(live_ct, ran)

        out: list[tuple[int, SampleOut]] = []
        drain = [slot for slot in range(self.s)
                 if self._slot_item[slot] is not None and done[slot]]
        if drain:
            # one gather + one transfer for the whole drain set (on a
            # mesh only the drained slots' results cross ranks)
            results = read_rows(self.state.result, drain).cpu()
        for j, slot in enumerate(drain):
            item = self._slot_item[slot]
            out.append(self._finish_lane(
                item, self._slot_iseq[slot], int(rounds_used[slot]),
                int(chosen[slot]), results[j], acc_round=self.round_count,
                slot=slot, admit_wall=self._admit_wall[slot],
                mode=self._slot_mode[slot],
                skips=int(skips[slot]) if skips is not None else 0))
            self._slot_item[slot] = None  # slot is free; done flag stays
            self._pred_done[slot] = None  # until the next admission clears
            # it (the lane is frozen)
        self._update_streak(live_ct, sum(it is not None
                                         for it in self._slot_item), ran)
        if not self.has_inflight:
            self._last_dispatch_done = None
        return out

    # -- the overlap loop: speculate, dispatch, verify ------------------------

    @contextlib.contextmanager
    def _no_sync(self):
        """The span that must not wait for the device (speculate ->
        dispatch, and the fast path's dispatch), as the profiler range
        ``overlap/no_sync``; with ``guard_syncs`` on CUDA, any synchronizing
        CUDA call inside it raises."""
        with torch.profiler.record_function("overlap/no_sync"):
            if not (self.guard_syncs and self.device.type == "cuda"):
                yield
                return
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    def _enqueue_readback(self, st, due: List[int]):
        """Enqueue the verify readback of ``st``: its flags and the due
        lanes' results. On CUDA this must be enqueued BEFORE the next
        round: on one stream a copy issued after round R+1 would wait for
        R+1 and turn the overlap back into the synchronous loop. So the
        flags and the gathered results are copied with ``non_blocking``
        into the current grid's pinned buffers and an event is recorded
        after them; :meth:`_collect_readback` waits for that event alone.
        The readback is collected in the same step, before any resize
        can install another grid."""
        flags = self._flags(st)
        if self.device.type != "cuda":
            return flags.numpy(), read_rows(st.result, due)
        rb_flags, rb_result = self._rb[self.s]
        idx = _to_device(torch.tensor(due, dtype=torch.int64), self.device)
        rb_flags.copy_(flags, non_blocking=True)
        rb_result[:len(due)].copy_(
            read_rows(st.result, due) if is_dtensor(st.result)
            else st.result.index_select(0, idx), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return event, rb_flags, rb_result[:len(due)]

    def _collect_readback(self, pending):
        """Block until the readback has landed (the ONE host sync of an
        event step); returns (done, rounds_used, chosen, skips or None, due
        results) on the host."""
        if self.device.type != "cuda":
            flags, res = pending
        else:
            event, rb_flags, rb_res = pending
            event.synchronize()
            flags = rb_flags.numpy().copy()
            res = rb_res.clone()  # the buffer is reused
        skips = flags[3] if self.lane_profile is not None else None
        return flags[0].astype(bool), flags[1], flags[2], skips, res

    def _step_overlap(self, max_rounds_on_device: int = 1
                      ) -> list[tuple[int, SampleOut]]:
        """One overlap step: speculate -> dispatch -> verify -> reconcile.

        Occupied lanes are classed by the cost model's predicted accept
        round (``_pred_done``). While no lane is *due*, up to
        ``max_rounds_on_device`` rounds are enqueued as one program with NO
        readback (the fast path; clipped so the next predicted accept still
        lands on a step boundary). When a lane is due, the
        host enqueues the readback of the state in flight, decides the
        next round against the *predicted* post-drain state (due lanes
        presumed finished), applies the decision speculatively, enqueues
        the next round, and only THEN waits for the readback:

        * prediction held: the round in flight is the one the synchronous
          loop would have issued (confirmed; with ``rtol=0`` predictions
          are exact and every step confirms);
        * prediction missed (a speculative admission targeted a lane still
          running): reinstate the retained pre-decision state, undo the
          host mirrors, re-decide against the true state and re-dispatch:
          one discarded device round, counted in
          ``speculation_rollbacks`` / ``speculated_rounds_wasted``.

        Drained results come from the kept pre-round state, and their
        latency/deadline accounting uses ``admit_round + rounds_used``:
        the synchronous loop's numbers, whenever the host discovers the
        accept. An elastic resize comes first, as in the synchronous loop:
        a round still in flight on the old grid precedes the migration in
        stream order, and this step's readback and rollback anchor belong
        to the grid installed here.
        """
        self._maybe_resize()
        now = self.round_count
        occupied = [i for i, it in enumerate(self._slot_item)
                    if it is not None]
        free = [i for i, it in enumerate(self._slot_item) if it is None]
        due = [s for s in occupied if self._pred_done[s] is None
               or self._pred_done[s] <= now]
        if not occupied and not len(self.queue):
            if self.min_slots != self.max_slots:
                self._low_streak += 1
            self._last_dispatch_done = None
            return []
        want_decide = bool(len(self.queue)) and \
            bool(free or due or self.policy.preemptive)

        if not due and not want_decide:
            # fast path: nothing can finish and nothing to decide; roll up
            # to R rounds in one program, clipped so the next predicted
            # accept lands on a step boundary; read NOTHING back
            r_dev = max(1, int(max_rounds_on_device))
            horizon = min(self._pred_done[s] - now for s in occupied)
            k = max(1, min(r_dev, horizon))
            with self._no_sync():
                self.state = self._dispatch(len(occupied),
                                            "roll" if k > 1 else "round", k)
            self.round_count = now + k
            self._count_rounds(len(occupied), k)
            self._update_streak(len(occupied), len(occupied), k)
            return []

        # -- event step: speculate + dispatch ahead of the verify ----------
        need_verify = bool(due)
        # drain metadata BEFORE the decision may overwrite it (a confirmed
        # speculative admission re-targets the due slot in the same step)
        due_meta = {s: (self._slot_item[s], self._slot_iseq[s],
                        self._admit_round[s], self._admit_wall[s],
                        self._slot_mode[s])
                    for s in due}
        dec, undo, spec_admits = Decision(), None, []
        dispatched = None
        prev = pending = None
        with self._no_sync():
            if need_verify:
                # the pre-decision state, kept for the verify readback and
                # for a rollback (the graph programs write theirs in place)
                prev = self._prog.keep(self.state)
                pending = self._enqueue_readback(prev, due)
            if want_decide:
                # predicted post-drain state: due lanes presumed finished;
                # sorted() matches the ascending free list of the
                # synchronous loop at the same step
                dec = self.policy.decide(self._view(
                    sorted(free + due), now=now,
                    lanes=[ln for ln in self._lane_views()
                           if ln.slot not in due_meta],
                    speculative=need_verify))
                spec_admits = [a.slot for a in dec.admissions
                               if a.slot in due_meta]
                if dec.admissions or dec.evictions:
                    undo = self._apply_decision(dec, now=now,
                                                record_undo=need_verify)
                    if spec_admits:
                        self._c_spec.inc()
            # lanes presumed running after the presumed drains: no round
            # when the grid would be empty (the synchronous loop runs none
            # on its final drain either)
            presumed_live = (len(occupied) - len(due)
                             + len(dec.admissions) - len(dec.evictions))
            if presumed_live > 0:
                dispatched = self._dispatch(presumed_live)
                self.round_count = now + 1

        out: list[tuple[int, SampleOut]] = []
        if need_verify:
            t0 = self.tracer.now()
            done, rounds_used, chosen, skips, due_res = \
                self._collect_readback(pending)
            self.tracer.span("verify/readback", t0, round_idx=now,
                             due=len(due))
            self._c_host_syncs.inc()
            failed = [s for s in spec_admits if not done[s]]
            if failed:
                # -- reconcile: a speculative admission hit a live lane --
                self._c_spec_rollbacks.inc()
                self.tracer.instant("spec/rollback", round_idx=now,
                                    slots=list(failed),
                                    wasted=int(dispatched is not None))
                if dispatched is not None:
                    self._c_spec_wasted.inc()
                    self.round_count = now
                dispatched = None
                self.state = self._prog.restore(prev)
                self._undo_decision(undo)
                out += self._drain_due(due, due_meta, done, rounds_used,
                                       chosen, due_res, skips)
                for s in due:
                    if not done[s] and self._slot_item[s] is not None:
                        self._pred_done[s] = now + 1  # re-verify next step
                free2 = [i for i, it in enumerate(self._slot_item)
                         if it is None]
                if len(self.queue) and (free2 or self.policy.preemptive):
                    self._apply_decision(
                        self.policy.decide(self._view(free2, now=now)),
                        now=now)
                if self.has_inflight:
                    dispatched = self._dispatch(sum(
                        it is not None for it in self._slot_item))
                    self.round_count = now + 1
            else:
                if spec_admits:
                    self._c_spec_confirms.inc()
                    self.tracer.instant("spec/confirm", round_idx=now,
                                        slots=list(spec_admits))
                adm_slots = {a.slot for a in dec.admissions}
                out += self._drain_due(due, due_meta, done, rounds_used,
                                       chosen, due_res, skips)
                self._trace_commit_undo(undo, now)
                for s in due:
                    if not done[s] and s not in adm_slots:
                        self._pred_done[s] = now + 1  # overdue: verify again
                # early accepts (actual < predicted) surface in the same
                # readback: drain them at the next step
                for s, it in enumerate(self._slot_item):
                    if it is not None and s not in due_meta \
                            and s not in adm_slots and done[s]:
                        self._c_drain_lag.inc()
                        self._pred_done[s] = now + 1

        live_now = sum(it is not None for it in self._slot_item)
        if dispatched is not None:
            self.state = dispatched
            self._count_rounds(live_now)
        self._update_streak(len(occupied), live_now,
                            int(dispatched is not None))
        if not self.has_inflight:
            self._last_dispatch_done = None
        return out

    def _drain_due(self, due, due_meta, done, rounds_used, chosen,
                   due_res, skips=None) -> list[tuple[int, SampleOut]]:
        """Drain the due lanes whose accept fired, from the kept pre-round
        state's readback. A slot whose speculative re-admission
        was confirmed already carries its NEW item in the mirrors: the old
        lane's identity comes from ``due_meta`` and the slot stays taken."""
        out = []
        for j, s in enumerate(due):
            item, i_seq, admit_round, admit_wall, mode = due_meta[s]
            if not done[s]:
                continue
            ru = int(rounds_used[s])
            out.append(self._finish_lane(
                item, i_seq, ru, int(chosen[s]), due_res[j],
                acc_round=admit_round + ru, slot=s, admit_wall=admit_wall,
                mode=mode, skips=int(skips[s]) if skips is not None else 0))
            if self._slot_item[s] is item:
                self._slot_item[s] = None  # freed; stale flags stay until
                self._pred_done[s] = None  # the next admission (frozen lane)
        return out

    def run_until_drained(self, max_rounds: Optional[int] = None,
                          max_rounds_on_device: int = 1
                          ) -> list[tuple[int, SampleOut]]:
        """Step until queue and grid are empty; returns all (rid, SampleOut)."""
        budget = max_rounds if max_rounds is not None else \
            2 * (len(self.queue) + self.max_slots) * (self.n + 1)  # preempt
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
        the reference's keys (and ``programs``), rendered from the metrics
        registry."""
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
            "overlap": self.overlap,
            "speculations": int(self._c_spec.value),
            "speculation_confirms": int(self._c_spec_confirms.value),
            "speculation_rollbacks": int(self._c_spec_rollbacks.value),
            "speculated_rounds_wasted": int(self._c_spec_wasted.value),
            "drain_lag_rounds": int(self._c_drain_lag.value),
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
            "min_slots": self.min_slots,
            "max_slots": self.max_slots,
            "wasted_slot_rounds": int(self._c_wasted.value),
            "resizes": int(self._c_resizes.value),
            "grows": int(self._c_grows.value),
            "shrinks": int(self._c_shrinks.value),
            "resize_vetoes": int(self._c_vetoes.value),
            "migrations": int(self._c_migrations.value),
            "buckets_visited": sorted(self._buckets_visited),
            "retraces": self.executor.retraces,
            "migration_traces": self.executor.migration_traces,
            "lane_modes_enabled": self.lane_profile is not None,
            "lane_profile": [sp.role + ("+skip" if sp.skip else "")
                             for sp in (self.lane_profile or ())],
            "lane_skips": int(self._c_lane_skips.value),
            "lane_served_nonexact": int(self._c_lane_nonexact.value),
            "lane_promotes": int(self._c_lane_promotes.value),
            "lane_skip_rate": {m: self.cost.skip_rate(m)
                               for m in ("adaptive", "draft")},
            "kernel_path": self.executor.kernel_path,
            "programs": self.executor.programs,
            "accept_rounds_observed": self.cost.accept_table_json(),
        }

    def write_trace(self, path: str, meta: Optional[dict] = None) -> dict:
        """Export this engine's trace and metrics snapshot as one Chrome
        trace-event JSON file (open it in ui.perfetto.dev; verify it with
        ``python -m repro_torch.obs check``). Host-side only: it reads the
        tracer's buffer and the registry, never the device."""
        from repro_torch.obs import write_chrome_trace
        self.stats()  # refresh the snapshot gauges
        info = {"engine": "continuous", "policy": self.policy.name,
                "overlap": self.overlap, "n_steps": self.n, "k": self.k,
                "lane_modes": self.lane_profile is not None}
        if meta:
            info.update(meta)
        return write_chrome_trace(path, self.tracer, metrics=self.metrics,
                                  meta=info)
