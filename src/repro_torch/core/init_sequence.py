"""Initialization-sequence selection (paper Section 2.3, Theorem 2.5).

Pure Python: a copy of ``repro.core.init_sequence`` (the port imports
nothing of the JAX package).

Continuous: t^(K) = (s-1)/s for target speedup s, then right-to-left

    t^(k) = 2 t^(k+1) - t^(k+2)   if t^(k+1) > (2/3) t^(k+2)
          = t^(k+1) / 2           otherwise                     (t^(K+1) := 1)

with t^(1) pinned to 0. Discrete sequences round onto the step grid; the
paper's configured presets for N=50 are reproduced exactly.
"""
from __future__ import annotations

from typing import Optional, Sequence

# Paper Section 4.1: sequences used in all experiments (N = 50).
PAPER_PRESETS = {
    (4, 50): [0, 8, 16, 32],
    (6, 50): [0, 3, 6, 12, 24, 36],
    (8, 50): [0, 2, 4, 8, 16, 24, 32, 40],
}


def speedup_of(i_seq: Sequence[int], n_steps: int, k: Optional[int] = None) -> float:
    """Paper Section 3: speedup of core k's output = N / (N - i_k + k - 1)."""
    k = len(i_seq) if k is None else k
    return n_steps / (n_steps - i_seq[k - 1] + k - 1)


def emit_round(i_seq: Sequence[int], n_steps: int, k: int) -> int:
    """1-based lockstep round at which core k (1-based) emits its output."""
    return n_steps - i_seq[k - 1] + k - 1


def theorem_sequence(num_cores: int, target_speedup: float) -> list[float]:
    """Continuous Theorem 2.5 sequence; I[0]=0, I[K-1]=(s-1)/s."""
    if num_cores < 1:
        raise ValueError("num_cores >= 1")
    s = target_speedup
    if num_cores == 1:
        return [0.0]
    t = [0.0] * num_cores
    t[-1] = (s - 1.0) / s
    nxt2 = 1.0  # t^(k+2)
    for k in range(num_cores - 2, 0, -1):  # 0-based positions K-2 .. 1
        t1 = t[k + 1]
        t[k] = 2.0 * t1 - nxt2 if t1 > (2.0 / 3.0) * nxt2 else t1 / 2.0
        t[k] = max(t[k], 0.0)
        nxt2 = t1
    t[0] = 0.0
    return t


def discretize(i_cont: Sequence[float], n_steps: int) -> list[int]:
    """Round continuous I onto {0..N-1}, enforcing strictly increasing, i_1=0."""
    k = len(i_cont)
    if k > n_steps:
        raise ValueError(f"cannot fit {k} cores into {n_steps} steps")
    idx = [min(int(round(v * n_steps)), n_steps - 1) for v in i_cont]
    idx[0] = 0
    # de-duplicate: push up left-to-right, then pull down right-to-left
    for j in range(1, k):
        idx[j] = max(idx[j], idx[j - 1] + 1)
    idx[-1] = min(idx[-1], n_steps - 1)
    for j in range(k - 2, 0, -1):
        idx[j] = min(idx[j], idx[j + 1] - 1)
    if idx[0] != 0 or any(b <= a for a, b in zip(idx, idx[1:])):
        raise ValueError(f"cannot fit {k} cores into {n_steps} steps: {idx}")
    return idx


def uniform_sequence(num_cores: int, n_steps: int, last: Optional[int] = None) -> list[int]:
    """Ablation baseline (paper Table 3), e.g. [0,6,12,...,42] for K=8, N=50."""
    if last is None:
        last = int(round(n_steps * (num_cores - 1) * 0.12)) if num_cores <= 8 else n_steps // 2
        last = min(last, n_steps - 1)
        if (num_cores, n_steps) == (8, 50):
            last = 42
    step = last / max(1, num_cores - 1)
    return [int(round(k * step)) for k in range(num_cores)]


def default_speedup(num_cores: int, n_steps: int) -> float:
    """Default target speedup ~ paper's operating points.

    The paper's presets follow t_K = 0.48 + 0.04 K (K=4: 0.64, 6: 0.72,
    8: 0.80); extrapolate with clipping for other K."""
    t_last = min(0.85, max(0.3, 0.48 + 0.04 * num_cores))
    return 1.0 / (1.0 - t_last)


def make_sequence(num_cores: int, n_steps: int, mode: str = "auto",
                  target_speedup: Optional[float] = None) -> list[int]:
    """Discrete initialization sequence I-hat.

    mode: "auto" (paper preset — exact or rescaled from N=50 — else theorem),
          "theorem", "uniform", "paper".
    """
    if mode in ("auto", "paper") and (num_cores, n_steps) in PAPER_PRESETS:
        return list(PAPER_PRESETS[(num_cores, n_steps)])
    if mode in ("auto", "paper") and (num_cores, 50) in PAPER_PRESETS \
            and target_speedup is None:
        scaled = [v * n_steps / 50.0 for v in PAPER_PRESETS[(num_cores, 50)]]
        return discretize([v / n_steps for v in scaled], n_steps)
    if mode == "paper":
        raise KeyError(f"no paper preset for K={num_cores}, N={n_steps}")
    if mode == "uniform":
        return uniform_sequence(num_cores, n_steps)
    s = target_speedup or default_speedup(num_cores, n_steps)
    return discretize(theorem_sequence(num_cores, s), n_steps)
