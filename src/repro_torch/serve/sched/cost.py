"""Rounds-to-finish cost model over the CHORDS emit schedule.

A copy of ``repro.serve.sched.cost`` for the port (pure Python, imports
rewritten to ``repro_torch``).

The whole point of SLA scheduling on a CHORDS grid is that per-request effort
is a *knob*: a more aggressive init sequence makes the fastest core emit
earlier (speedup ``N / (N - i_K + K - 1)``) at the price of accuracy margin.
This module predicts, host-side and in closed form via
``repro.core.scheduler.emit_rounds``, how many lockstep rounds a request will
take under a given init sequence — so a policy can pick the *least*
aggressive sequence that still meets the deadline instead of mapping
priority -> i_seq by fixed table.

Prediction semantics (documented knob, not an oracle):

* The streaming accept test needs two consecutive emissions to agree, so the
  earliest possible accept is the second arrival — core ``K-2``'s emit round.
  ``accept_arrival`` (default 2) says which arrival we assume passes:
  ``predict_rounds = emit_rounds[K - accept_arrival]`` (clamped to core 0).
* ``rtol == 0`` disables early exit entirely (the engine force-accepts core
  0's exact sequential solve at round N), so prediction is the worst case
  ``emit_rounds[0] == N`` — deterministic, which is what the CI workload
  uses to make miss counts reproducible.
* **Calibration**: the engine reports every observed accept round back via
  ``observe_accept(i_seq, rtol, rounds, mode)``; once a ``(i_seq, rtol,
  mode)`` key has observations, ``predict_rounds`` returns the EMA of the
  observed rounds (clamped to the feasible emission window) instead of the
  fixed ``accept_arrival`` heuristic. The heuristic remains the cold-start
  default, and the ``rtol <= 0`` closed form is never overridden (it is
  exact in every mode — core 0 never skips — and CI determinism relies on
  it).
* **Cold start for new keys**: every observation also feeds a
  *mode-agnostic* ``(i_seq, rtol)`` aggregate EMA, and an unobserved
  mode-keyed lookup falls back through it before reaching the
  ``accept_arrival`` heuristic — so the first ``mode="adaptive"`` request
  on an already-exercised sequence starts from measured rounds, not the
  table preset (the per-key tables otherwise cold-start badly).
* **Skip calibration**: heterogeneous drains report committed skip counts
  via ``observe_skips(mode, skips, rounds)``; the per-mode skip-rate EMA
  discounts non-exact cold-start predictions (``base / (1 + rate)``) so the
  model prices the skip-accelerated emission schedule it actually observes.

The ladder of candidate sequences is shared with the engine's priority
table: level 0 is the paper preset/theorem default (``make_sequence(K, N)``),
level ``p`` targets ``default_speedup * priority_speedup**p``. This keeps
"policy chose level p" and "request asked for priority p" bit-identical
code paths (the serve tests rely on it).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import scheduler
from repro_torch.core.init_sequence import default_speedup, make_sequence

MAX_LADDER_LEVEL = 6


class CostModel:
    """Host-side round predictions for one engine's (K, N) grid."""

    def __init__(self, num_cores: int, n_steps: int,
                 priority_speedup: float = 1.25, accept_arrival: int = 2,
                 ema_alpha: float = 0.25, metrics=None):
        self.k = num_cores
        self.n = n_steps
        self.priority_speedup = priority_speedup
        self.accept_arrival = accept_arrival
        self.ema_alpha = ema_alpha
        self._ladder: List[List[int]] = []
        # (i_seq tuple, rtol, mode) -> [ema_rounds, observation_count]
        self._accept_table: dict = {}
        # (i_seq tuple, rtol) -> [ema_rounds, count]: mode-agnostic
        # aggregate — the cold-start fallback for unobserved mode keys
        self._agg_table: dict = {}
        # mode -> [ema skips-per-round, count] from heterogeneous drains
        self._skip_rate: dict = {}
        # metrics is the engine's registry when the engine built this model
        # (trailing kwarg: every existing positional call site is unchanged)
        if metrics is None:
            from repro_torch.obs import MetricsRegistry
            metrics = MetricsRegistry()
        self.metrics = metrics
        self._c_observations = metrics.counter("sched.cost.observations")
        self._c_predictions = metrics.counter("sched.cost.predictions")
        self._g_keys = metrics.gauge("sched.cost.calibrated_keys")
        self._h_accept = metrics.histogram("sched.cost.accept_rounds")

    # -- init-sequence ladder --------------------------------------------------

    def seq_for_level(self, level: int) -> List[int]:
        """Ladder level -> init sequence (level == request priority).

        Level 0 is ``make_sequence(K, N)``; level p targets
        ``default_speedup * priority_speedup**p``. Falls back to the highest
        constructible level when discretization can't fit the target."""
        level = max(0, min(level, MAX_LADDER_LEVEL))
        while len(self._ladder) <= level:
            p = len(self._ladder)
            if p == 0:
                self._ladder.append(make_sequence(self.k, self.n))
                continue
            target = default_speedup(self.k, self.n) \
                * self.priority_speedup ** p
            try:
                self._ladder.append(
                    make_sequence(self.k, self.n, mode="theorem",
                                  target_speedup=target))
            except ValueError:
                self._ladder.append(self._ladder[-1])
        return list(self._ladder[level])

    def ladder(self) -> List[List[int]]:
        self.seq_for_level(MAX_LADDER_LEVEL)
        return [list(s) for s in self._ladder]

    # -- predictions -----------------------------------------------------------

    @staticmethod
    def _norm_mode(mode: Optional[str]) -> str:
        return str(mode) if mode else "exact"

    @classmethod
    def _accept_key(cls, i_seq: Sequence[int], rtol: Optional[float],
                    mode: Optional[str] = "exact"):
        return (tuple(int(i) for i in i_seq),
                None if rtol is None else float(rtol),
                cls._norm_mode(mode))

    def _ema_update(self, table: dict, key, value: float) -> None:
        ent = table.get(key)
        if ent is None:
            table[key] = [float(value), 1]
        else:
            ent[0] = self.ema_alpha * value + (1 - self.ema_alpha) * ent[0]
            ent[1] += 1

    def observe_accept(self, i_seq: Optional[Sequence[int]],
                       rtol: Optional[float], rounds: int,
                       mode: Optional[str] = "exact") -> None:
        """Feed one observed accept (lockstep rounds at which the streaming
        test fired) into the EMA tables: the ``(i_seq, rtol, mode)`` key AND
        the mode-agnostic ``(i_seq, rtol)`` aggregate (the cold-start
        fallback for sibling modes of the same sequence).

        ``rtol <= 0`` observations are discarded: that path is closed-form
        exact (always ``N``) and the CI workloads rely on its determinism.
        """
        if i_seq is None or rtol is None or rtol <= 0.0:
            return
        self._c_observations.inc()
        self._h_accept.observe(rounds)
        key = self._accept_key(i_seq, rtol, mode)
        had = key in self._accept_table
        self._ema_update(self._accept_table, key, float(rounds))
        self._ema_update(self._agg_table, key[:2], float(rounds))
        if not had:
            self._g_keys.set(float(len(self._accept_table)))

    def observe_skips(self, mode: Optional[str], skips: int,
                      rounds: int) -> None:
        """Feed one heterogeneous drain's committed skip count: the per-mode
        skips-per-round EMA discounts that mode's cold-start predictions."""
        mode = self._norm_mode(mode)
        if mode == "exact" or rounds <= 0:
            return
        self._ema_update(self._skip_rate, mode,
                         float(skips) / float(max(1, rounds)))

    def skip_rate(self, mode: Optional[str]) -> float:
        """Observed skips-per-round EMA for ``mode`` (0.0 before any
        heterogeneous drain of that mode)."""
        ent = self._skip_rate.get(self._norm_mode(mode))
        return float(ent[0]) if ent else 0.0

    def accept_table_json(self) -> list:
        """Observed-accept table as JSON-able records (for stats/artifacts)."""
        return [{"i_seq": list(seq), "rtol": rtol, "mode": mode,
                 "ema_rounds": round(ent[0], 3), "observations": ent[1]}
                for (seq, rtol, mode), ent
                in sorted(self._accept_table.items())]

    def predict_rounds(self, i_seq: Sequence[int],
                       rtol: Optional[float] = None,
                       mode: Optional[str] = "exact") -> int:
        """Lockstep rounds until this sequence's assumed accept fires.

        Calibrated by the EMA of observed accepts for this exact
        ``(i_seq, rtol, mode)`` when available; an unobserved key falls back
        through the mode-agnostic ``(i_seq, rtol)`` aggregate EMA, then the
        ``accept_arrival`` heuristic — fallback predictions for non-exact
        modes are discounted by the observed per-mode skip rate."""
        self._c_predictions.inc()
        mode = self._norm_mode(mode)
        emit = scheduler.emit_rounds(list(i_seq), self.n)
        if rtol is not None and rtol <= 0.0:
            return int(emit[0])  # exact sequential fallback: worst case N
        # clamp to the feasible accept window: no earlier than the 2nd
        # streamed arrival (the test needs two; skipping pulls it below the
        # static table, so non-exact modes clamp only to >= 1), no later
        # than core 0
        lo = int(emit[max(0, len(i_seq) - 2)]) if mode == "exact" else 1
        hi = int(emit[0])
        ent = self._accept_table.get(self._accept_key(i_seq, rtol, mode))
        if ent is not None:
            return int(min(max(round(ent[0]), lo), hi))
        agg = self._agg_table.get(self._accept_key(i_seq, rtol)[:2])
        if agg is not None:
            base = float(agg[0])
        else:
            base = float(emit[max(0, len(i_seq) - self.accept_arrival)])
        if mode != "exact":
            base /= 1.0 + self.skip_rate(mode)
        return int(min(max(round(base), lo), hi))

    def worst_case_rounds(self, i_seq: Sequence[int]) -> int:
        """Core 0's emit round — always N (the sequential solve)."""
        return int(scheduler.emit_rounds(list(i_seq), self.n)[0])

    def remaining_rounds(self, i_seq: Sequence[int], rounds_done: int,
                         rtol: Optional[float] = None,
                         mode: Optional[str] = "exact") -> int:
        """Predicted rounds left for an in-flight lane (>= 1: a live lane
        that outran the prediction can accept on any upcoming emission).

        ``rounds_done`` must count rounds in the current admission only — a
        re-admitted lane restarts from fresh noise, so rounds credited from
        a previous admission (``QueueItem.rounds_credit``) reduce *queue
        aging*, never remaining work (victim ranking accounts for them via
        ``LaneView.invested`` instead).
        """
        return max(1, self.predict_rounds(i_seq, rtol, mode) - rounds_done)

    def predict_done_round(self, i_seq: Sequence[int], rtol: Optional[float],
                           admit_round: int,
                           mode: Optional[str] = "exact") -> int:
        """Absolute engine round at which a lane admitted at ``admit_round``
        is predicted to accept — the async engine's speculation horizon.

        For ``rtol <= 0`` this is *exact* (``admit_round + N``: the engine
        force-accepts core 0's sequential solve, deterministically), which
        is why speculation on the deterministic CI workloads always
        confirms. For calibrated/heuristic predictions it is a best guess;
        the engine reconciles a miss by rolling back the speculative
        admission (bounded, counted work — never wrong results).
        """
        return int(admit_round) + max(1, self.predict_rounds(i_seq, rtol,
                                                             mode))

    def wait_rounds(self, free_slots: int,
                    inflight_remaining: Sequence[int]) -> float:
        """Predicted rounds until a slot frees given current occupancy."""
        if free_slots > 0:
            return 0
        if not inflight_remaining:
            return math.inf  # no free slot and nothing draining: unservable
        return min(inflight_remaining)

    def pick_i_seq(self, budget_rounds: float,
                   min_level: int = 0,
                   rtol: Optional[float] = None,
                   mode: Optional[str] = "exact"
                   ) -> Tuple[List[int], int, int]:
        """Least aggressive ladder level whose prediction fits the budget.

        Returns ``(i_seq, predicted_rounds, level)``. When even the top
        level misses the budget the top level is returned anyway (the
        request is admitted best-effort; the miss is the workload's fault,
        and stats will say so)."""
        chosen = None
        for level in range(max(0, min_level), MAX_LADDER_LEVEL + 1):
            seq = self.seq_for_level(level)
            pred = self.predict_rounds(seq, rtol, mode)
            chosen = (seq, pred, level)
            if pred <= budget_rounds:
                break
        return chosen
