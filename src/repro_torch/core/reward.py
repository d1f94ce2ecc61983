"""Reward surrogate R(I) (paper Definition 2.4, Appendix A.2) — a copy of
``repro.core.reward`` for the port (pure Python; equal to it to the bit).

Continuous-time event simulation of Framework 2.2 on the exponential ODE
f(x,t) = x with x_0 = 1: between events every core multiplies by e^{dt};
rectification events for pair (k-1, k) occur at wall times n * delta_k
(delta_k = t_k - t_{k-1}); the snapshot argument is the fast core's value one
event earlier (its trajectory value at position t_{k-1} + n delta_k).
Simultaneous events use pre-update values, matching Algorithm 1's
synchronize-then-apply semantics.

R(I) = ln x_1^K per coordinate (D=1 wlog). The single-core solve gives
R = ln e = 1 exactly (Def. 2.4 optimality).
"""
from __future__ import annotations

import math
from typing import Sequence


def reward(i_cont: Sequence[float], eps: float = 1e-12) -> float:
    """R(I) = ln of the fastest core's terminal value on f(x)=x, x0=1."""
    t = list(i_cont)
    k = len(t)
    if k == 1:
        return 1.0  # exact solve: ln(e^1)
    if t[0] != 0.0 or any(b <= a for a, b in zip(t, t[1:])) or t[-1] >= 1.0:
        raise ValueError(f"bad init sequence {t}")

    # initialization: core j at position t_j with x = x0 + t_j * f(x0) = 1 + t_j
    x = [1.0 + tj for tj in t]
    x[0] = 1.0  # core 1 starts exactly at x0
    snap = list(x)  # snapshot = value at previous event (init: wall 0)
    end_wall = [1.0 - tj for tj in t]  # termination wall time per core

    # build event list: (wall_time, core_k) for each pair (k-1, k)
    events = []
    for j in range(1, k):
        dj = t[j] - t[j - 1]
        n = 1
        while n * dj <= end_wall[j] + eps:
            events.append((n * dj, j))
            n += 1
    events.sort(key=lambda e: (e[0], e[1]))

    wall = 0.0
    idx = 0
    while idx < len(events):
        tau = events[idx][0]
        # advance all cores to wall tau (cores stop growing at their end time)
        for j in range(k):
            dt = min(tau, end_wall[j]) - min(wall, end_wall[j])
            if dt > 0:
                x[j] *= math.exp(dt)
        # collect simultaneous events, apply with pre-update values
        group = []
        while idx < len(events) and abs(events[idx][0] - tau) < eps:
            group.append(events[idx][1])
            idx += 1
        x_before = list(x)
        for j in group:
            if tau > end_wall[j] + eps:
                continue
            dj = t[j] - t[j - 1]
            # r = delta*(f(x_slow) - f(snap)) + x_slow - snap ; f(x)=x
            r = (1.0 + dj) * (x_before[j - 1] - snap[j])
            x[j] = x_before[j] + r
            snap[j] = x[j]
        wall = tau

    # advance fastest core to its end
    j = k - 1
    if wall < end_wall[j]:
        x[j] *= math.exp(end_wall[j] - wall)
    return math.log(max(x[j], eps))


def speedup_cont(i_cont: Sequence[float]) -> float:
    """Definition 2.3: S(I) = 1 / (1 - t_K)."""
    return 1.0 / (1.0 - i_cont[-1])
