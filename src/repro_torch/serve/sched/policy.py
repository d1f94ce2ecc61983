"""Scheduling policies: the decision layer between queue and slot grid.

A copy of ``repro.serve.sched.policy`` for the port (pure Python, imports
rewritten to ``repro_torch``).

A policy sees a host-side :class:`EngineView` (queue, free slots, in-flight
lane views, the cost model, the current round) and returns a
:class:`Decision`: which queued items go into which slots with which init
sequence, and which in-flight lanes to evict to make room. The engine
applies the decision with the existing masked ``reset_slots`` admission
program — policies never touch device state, so every guarantee of the slot
grid (recycling invisibility, bit-identity of untouched lanes) holds under
any policy by construction.

* ``FifoPolicy`` — PR 3 behavior, the default: submission-order admission,
  init sequence from the request's priority, never preempts.
* ``EdfPolicy`` — pops the queue in (effective class, deadline, seq) order
  and asks the cost model for the cheapest init sequence that still meets
  the item's remaining deadline budget (floored at the request's priority
  level so no-deadline requests behave exactly like FIFO's).

**Lane modes** (heterogeneous grids): a request's ``mode`` ("exact" |
"draft" | "adaptive") is an *opt-in permission* to serve it degraded, not a
hard routing. FIFO serves the requested mode as-is. EDF treats a non-exact
mode as headroom: a deadline-free request keeps its requested mode, and a
deadlined one is served **exact whenever exact fits the budget** — the
scheduler only *downgrades* to the request's opted mode when the deadline is
tight (no ladder level meets the budget at exact pricing). On engines
without a lane profile ``EngineView.lane_modes`` is False and every request
prices — and runs — as exact.
* ``EdfPreemptPolicy`` — EDF, plus: when the queue head would miss its
  deadline waiting for a natural drain but would meet it if admitted now,
  evict the lowest-value in-flight lane (max slack, then least progress;
  lanes already evicted ``max_preemptions`` times are immune, which bounds
  thrash and guarantees every request eventually runs to completion). The
  evicted request re-enters the queue with its executed rounds credited
  (``QueueItem.rounds_credit`` — pre-aged, so it is promoted, not punished).

Alongside admissions/evictions, policies rule on **elastic capacity**: the
demand-paged engine proposes grid resizes (:class:`ResizeProposal`) and the
policy answers with a :class:`Resize` (approve) or ``None`` (veto). Growth
is always approved; EDF-family policies veto a shrink that would push a
queued deadline into a predicted miss (the freed lanes are load-bearing).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.serve.sched.cost import CostModel
from repro_torch.serve.sched.queue import AdmissionQueue, QueueItem


@dataclasses.dataclass
class LaneView:
    """Host-side snapshot of one occupied slot (no device sync needed:
    every live lane advances exactly one lockstep round per engine round).

    ``rounds_done`` counts rounds in the *current* admission only (that is
    what ``cost.remaining_rounds`` needs: a re-admitted lane restarts its
    solve from fresh noise, so credited rounds do not reduce remaining
    work). ``invested`` additionally includes ``item.rounds_credit`` — the
    rounds a preempted request already burned before eviction — and is the
    sunk-compute measure preemption victim ranking must use: evicting the
    lane with the least *total* investment wastes the least device work.
    """

    slot: int
    item: QueueItem
    rounds_done: int
    est_remaining: int
    invested: int = -1  # defaults to rounds_done (see __post_init__)

    def __post_init__(self):
        if self.invested < 0:
            self.invested = self.rounds_done

    def slack(self, now: int) -> float:
        return self.item.deadline_round - now - self.est_remaining


@dataclasses.dataclass
class EngineView:
    """What a policy sees when asked to decide.

    ``speculative=True`` marks a view built by the async engine *ahead* of
    the verifying readback: ``free_slots`` then includes lanes the cost
    model predicts will have drained by ``now`` (and ``lanes`` excludes
    them). Policies need not branch on it — the view is constructed to be
    exactly what the synchronous engine would present at the same round
    when the prediction holds, which is what makes confirmed speculation
    bitwise-identical to the synchronous path. The flag exists for
    introspection/logging and for policies that want to hedge.
    """

    now: int
    queue: AdmissionQueue
    free_slots: List[int]
    lanes: List[LaneView]
    cost: CostModel
    speculative: bool = False
    # True when the engine's grid carries a lane profile (heterogeneous
    # modes actually executable); policies price non-exact modes only then
    lane_modes: bool = False


def request_mode(view: EngineView, item: QueueItem) -> str:
    """The mode this item can be *served* at: the request's opted mode on a
    lane-profiled engine, else "exact" (so pricing never assumes a skip
    schedule the grid cannot execute)."""
    if not view.lane_modes:
        return "exact"
    return getattr(item.payload, "mode", "exact") or "exact"


@dataclasses.dataclass
class Admission:
    slot: int
    item: QueueItem
    i_seq: List[int]
    predicted_rounds: int
    level: int
    mode: str = "exact"


@dataclasses.dataclass
class Decision:
    admissions: List[Admission] = dataclasses.field(default_factory=list)
    evictions: List[int] = dataclasses.field(default_factory=list)
    # invariant (engine-asserted): every evicted slot is re-filled by one of
    # ``admissions`` in the same decision — eviction exists only to admit.


@dataclasses.dataclass(frozen=True)
class ResizeProposal:
    """An engine's proposed capacity change on the bucket ladder.

    Shrinks (``new_slots < current_slots``) are only ever proposed when the
    live lanes fit the smaller grid — a resize migrates lanes, it never
    evicts them — so what a policy weighs is *future* admission capacity:
    would the queued work (deadlines included) still be servable with
    ``new_slots - live_lanes`` free lanes?
    """

    current_slots: int
    new_slots: int
    live_lanes: int
    queued: int


@dataclasses.dataclass(frozen=True)
class Resize:
    """Approved capacity-change decision (the elastic analog of
    :class:`Decision`): the engine retargets the grid to ``new_slots`` and
    migrates live lanes bit-exactly."""

    new_slots: int


class Policy:
    """Base policy == FIFO (the PR 3 default)."""

    name = "fifo"
    preemptive = False

    def consider_resize(self, view: EngineView, proposal: ResizeProposal
                        ) -> Optional[Resize]:
        """Approve (return :class:`Resize`) or veto (``None``) a proposed
        capacity change. Growth is always approved — more capacity cannot
        hurt a deadline. The base (FIFO) policy approves shrinks too: with
        no deadline semantics there is nothing a smaller grid can break."""
        return Resize(proposal.new_slots)

    def _admission(self, view: EngineView, slot: int, item: QueueItem
                   ) -> Admission:
        mode = request_mode(view, item)
        seq = view.cost.seq_for_level(item.priority)
        return Admission(slot=slot, item=item, i_seq=seq,
                         predicted_rounds=view.cost.predict_rounds(
                             seq, item.rtol, mode),
                         level=max(0, item.priority), mode=mode)

    def _pop(self, view: EngineView) -> Optional[QueueItem]:
        return view.queue.pop_fifo()

    def decide(self, view: EngineView) -> Decision:
        dec = Decision()
        for slot in view.free_slots:
            item = self._pop(view)
            if item is None:
                break
            dec.admissions.append(self._admission(view, slot, item))
        return dec


class FifoPolicy(Policy):
    pass


class EdfPolicy(Policy):
    name = "edf"

    def consider_resize(self, view: EngineView, proposal: ResizeProposal
                        ) -> Optional[Resize]:
        """Veto a shrink that would turn a *currently-feasible* queued
        deadline into a predicted miss: for every queued item with a finite
        deadline, re-run the admission feasibility check (cheapest meeting
        sequence + predicted wait for a free lane) against the post-shrink
        free capacity. Items already missing at the current capacity are
        not the shrink's fault and never block it."""
        if proposal.new_slots >= proposal.current_slots:
            return Resize(proposal.new_slots)
        free_now = proposal.current_slots - proposal.live_lanes
        free_after = proposal.new_slots - proposal.live_lanes
        remaining = [ln.est_remaining for ln in view.lanes]
        wait_now = view.cost.wait_rounds(free_now, remaining)
        wait_after = view.cost.wait_rounds(free_after, remaining)
        for item in view.queue.ordered(view.now):
            budget = item.deadline_round - view.now
            if math.isinf(budget):
                continue
            _, need, _ = view.cost.pick_i_seq(
                budget, min_level=max(0, item.priority), rtol=item.rtol,
                mode=request_mode(view, item))
            if need + wait_now > budget:
                continue  # missing either way: the shrink changes nothing
            if need + wait_after > budget:
                return None  # this lane capacity is load-bearing: keep it
        return Resize(proposal.new_slots)

    def _pop(self, view: EngineView) -> Optional[QueueItem]:
        return view.queue.pop(view.now)

    def _admission(self, view: EngineView, slot: int, item: QueueItem
                   ) -> Admission:
        budget = item.deadline_round - view.now
        mode = request_mode(view, item)
        if mode != "exact" and math.isfinite(budget):
            # a non-exact mode is permission, not a mandate: serve exact
            # when exact still meets the deadline; downgrade to the opted
            # mode only when the deadline is tight
            seq, pred, level = view.cost.pick_i_seq(
                budget, min_level=max(0, item.priority), rtol=item.rtol,
                mode="exact")
            if pred <= budget:
                return Admission(slot=slot, item=item, i_seq=seq,
                                 predicted_rounds=pred, level=level,
                                 mode="exact")
        seq, pred, level = view.cost.pick_i_seq(
            budget, min_level=max(0, item.priority), rtol=item.rtol,
            mode=mode)
        return Admission(slot=slot, item=item, i_seq=seq,
                         predicted_rounds=pred, level=level, mode=mode)


class EdfPreemptPolicy(EdfPolicy):
    name = "edf-preempt"
    preemptive = True

    def __init__(self, max_preemptions: int = 1):
        self.max_preemptions = max_preemptions

    def _pick_victim(self, view: EngineView, head_slack: float,
                     taken: Sequence[int]) -> Optional[LaneView]:
        """Lowest-value lane: maximum slack (no deadline == inf slack goes
        first), then least sunk compute — ``invested``, i.e. rounds in the
        current admission PLUS rounds credited from earlier evictions.
        (Ranking on ``rounds_done`` alone re-victimized freshly re-admitted
        lanes: a request that had already burned rounds before preemption
        looked like the least-progressed lane right after re-admission.)
        A victim must have strictly more slack than the head gains — never
        trade one miss for another — and must not have exhausted its
        preemption budget."""
        candidates = [
            ln for ln in view.lanes
            if ln.slot not in taken
            and ln.item.preemptions < self.max_preemptions
            and ln.slack(view.now) > max(head_slack, 0)
        ]
        if not candidates:
            return None
        return max(candidates,
                   key=lambda ln: (ln.slack(view.now), -ln.invested))

    def decide(self, view: EngineView) -> Decision:
        dec = super().decide(view)  # EDF admissions into naturally free slots
        taken = [a.slot for a in dec.admissions]
        remaining = [ln.est_remaining for ln in view.lanes
                     if ln.slot not in taken]
        while len(view.queue):
            head = view.queue.peek(view.now)
            budget = head.deadline_round - view.now
            if math.isinf(budget):
                break  # head (and thus everything behind it) can wait
            # preemption is by definition the tight case: price the head at
            # its opted (possibly downgraded) mode directly
            head_mode = request_mode(view, head)
            seq, need, level = view.cost.pick_i_seq(
                budget, min_level=max(0, head.priority), rtol=head.rtol,
                mode=head_mode)
            wait = view.cost.wait_rounds(0, remaining)
            if need > budget:
                break   # hopeless even if admitted now: don't waste a lane
            if need + wait <= budget:
                break   # meets its deadline by waiting: no eviction needed
            victim = self._pick_victim(view, head_slack=budget - need,
                                       taken=taken)
            if victim is None:
                break
            view.queue.pop(view.now)  # == head
            dec.evictions.append(victim.slot)
            dec.admissions.append(Admission(
                slot=victim.slot, item=head, i_seq=seq,
                predicted_rounds=need, level=level, mode=head_mode))
            taken.append(victim.slot)
            remaining = [ln.est_remaining for ln in view.lanes
                         if ln.slot not in taken]
        return dec


POLICIES = {p.name: p for p in (FifoPolicy, EdfPolicy, EdfPreemptPolicy)}


def get_policy(name_or_policy) -> Policy:
    """'fifo' | 'edf' | 'edf-preempt' | a Policy instance (passed through)."""
    if isinstance(name_or_policy, Policy):
        return name_or_policy
    if name_or_policy is None:
        return FifoPolicy()
    try:
        return POLICIES[name_or_policy]()
    except KeyError:
        raise KeyError(
            f"unknown policy {name_or_policy!r}; known: {sorted(POLICIES)}")
