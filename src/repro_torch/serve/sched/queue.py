"""Deadline/priority admission queue — the pure-Python scheduling reference.

A copy of ``repro.serve.sched.queue`` for the port (pure Python, imports
rewritten to ``repro_torch``).

Ordering is lexicographic at pop time ``now`` (engine lockstep rounds):

1. **effective class**, descending —
   ``priority + (now - submit_round + rounds_credit) // aging_rounds``.
   Aging promotes a waiting request one class every ``aging_rounds`` rounds,
   so no fixed-priority stream can starve it: a class-``q`` item can only be
   outranked by class-``p`` (p > q) items submitted within roughly
   ``aging_rounds * (p - q)`` rounds of it — a finite window, hence a finite
   number of overtakers (tested bound in ``tests/test_sched.py``).
   ``rounds_credit`` (lockstep rounds a preempted request already ran before
   eviction) counts as pre-aged wait, so preemption accelerates re-admission
   instead of resetting the request to the back of its class.
2. **absolute deadline round**, ascending (EDF) — ``submit_round +
   deadline_rounds``; no deadline sorts last (``math.inf``).
3. **submission sequence**, ascending (FIFO tie-break).

Within one effective class the order is therefore exactly EDF and can never
invert two deadlines (hypothesis property). The queue is deliberately plain
Python over a list (O(n) pop, n = queued requests, tiny in practice): it is
the *reference semantics* the policies and tests are written against.

``pop_fifo`` ignores all of the above and pops in submission order — the
FIFO policy (PR 3 behavior) runs through the same queue object.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, List, Optional


@dataclasses.dataclass
class QueueItem:
    """One queued request plus its scheduling state.

    ``deadline_round`` is *absolute* (engine round by which the request must
    finish), already ``submit_round + Request.deadline_rounds``; ``math.inf``
    when the request has no deadline. ``payload`` is the engine's Request —
    the queue never looks inside it.
    """

    payload: Any
    priority: int
    submit_round: int
    deadline_round: float
    seq: int
    rtol: Optional[float] = None
    rounds_credit: int = 0   # lockstep rounds run before an eviction
    preemptions: int = 0     # times this request was evicted mid-flight

    def slack(self, now: int, est_remaining: float) -> float:
        """Rounds to spare if the request finishes in ``est_remaining`` more
        rounds starting now (negative = projected miss)."""
        return self.deadline_round - now - est_remaining


class AdmissionQueue:
    """EDF + priority classes + starvation aging (see module docstring)."""

    def __init__(self, aging_rounds: int = 32):
        if aging_rounds < 1:
            raise ValueError("aging_rounds >= 1")
        self.aging_rounds = aging_rounds
        self._items: List[QueueItem] = []
        self._seq = 0

    def submit(self, payload, priority: int = 0, submit_round: int = 0,
               deadline_rounds: Optional[int] = None,
               rtol: Optional[float] = None) -> QueueItem:
        """Wrap and enqueue; deadline is relative to ``submit_round``."""
        deadline = math.inf if deadline_rounds is None \
            else submit_round + deadline_rounds
        item = QueueItem(payload=payload, priority=priority,
                         submit_round=submit_round, deadline_round=deadline,
                         seq=self._seq, rtol=rtol)
        self._seq += 1
        self._items.append(item)
        return item

    def push(self, item: QueueItem) -> None:
        """Re-enqueue an existing item (eviction re-entry): submit round,
        deadline, seq, and accumulated ``rounds_credit`` are preserved."""
        self._items.append(item)

    def remove(self, item: QueueItem) -> None:
        """Drop ``item`` (by identity) from the queue — the inverse of
        :meth:`push`, used when a speculative eviction is rolled back.
        Ordering is recomputed from item keys at every pop, so push/remove
        round-trips cannot perturb the pop order of the survivors."""
        self._items.remove(item)

    def effective_class(self, item: QueueItem, now: int) -> int:
        waited = max(0, now - item.submit_round) + item.rounds_credit
        return item.priority + waited // self.aging_rounds

    def sort_key(self, item: QueueItem, now: int):
        return (-self.effective_class(item, now), item.deadline_round,
                item.seq)

    def ordered(self, now: int) -> List[QueueItem]:
        """Current pop order (non-destructive; the testable reference)."""
        return sorted(self._items, key=lambda it: self.sort_key(it, now))

    def peek(self, now: int) -> Optional[QueueItem]:
        if not self._items:
            return None
        return min(self._items, key=lambda it: self.sort_key(it, now))

    def pop(self, now: int) -> Optional[QueueItem]:
        item = self.peek(now)
        if item is not None:
            self._items.remove(item)
        return item

    def pop_fifo(self) -> Optional[QueueItem]:
        """Submission-order pop (the PR 3 FIFO admission semantics)."""
        if not self._items:
            return None
        item = min(self._items, key=lambda it: it.seq)
        self._items.remove(item)
        return item

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[QueueItem]:
        return iter(self._items)
