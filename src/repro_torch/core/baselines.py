"""Baseline parallel diffusion samplers (paper Section 4.1) — port of
``repro.core.baselines``.

* ``paradigms_sample`` — sliding-window Picard iteration (Shih et al. 2024).
  One "round" = one drift call over the window's rows (window size =
  number of cores): the port's drift takes a time per row, so the window is
  one call where the reference ``vmap``s.
* ``srds_sample`` — parareal / self-refining diffusion sampler (Selvam et al.
  2024): coarse sequential sweep + parallel fine solves + parareal correction.
  Rounds = sequential-NFE-equivalents: init sweep M, per iteration
  (segment_len fine rounds, since segments run on parallel cores) + M coarse.

Both are host-driven loops around drift calls (dynamic convergence), as in
the reference, and take its host decisions the same way:

* ParaDiGMS keeps the window's states on the host in numpy f32, as the
  reference does, so the prefix sum is ``np.cumsum`` over the window's
  rows: a sequential f32 sum from the window's first row to its last, the
  reference's order. ``err[m] < tol`` compares a numpy f32 element, as the
  reference does.
* SRDS cuts the grid at ``round(j * n / m)`` (Python's round half to even)
  and solves its fine segments one after another, as the reference runs
  them: batching them would change the drift's GEMM shapes.
* ``rounds`` is counted where the reference counts it.

Speedup metric = N / rounds, identical to the paper's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ode import DriftFn
from repro_torch.device import resolve_device


@dataclasses.dataclass
class BaselineResult:
    output: torch.Tensor
    rounds: int
    n_steps: int
    iters: int = 0

    @property
    def speedup(self) -> float:
        return self.n_steps / max(1, self.rounds)


def _rel_err(new, old, eps=1e-12):
    """Per-row ``rms(new - old) / (rms(new) + eps)`` over all but axis 0."""
    dims = tuple(range(1, new.ndim))
    num = torch.sqrt(torch.mean((new - old) ** 2, dim=dims))
    den = torch.sqrt(torch.mean(new ** 2, dim=dims)) + eps
    return num / den


def paradigms_sample(drift: DriftFn, x0, tgrid, window: int, tol: float = 2e-3,
                     max_rounds: int = 10_000, device="cuda") -> BaselineResult:
    dev = resolve_device(device)
    tgrid = torch.as_tensor(tgrid).to(dev)
    x0 = torch.as_tensor(x0)
    n = int(tgrid.shape[0]) - 1
    x0n = x0.detach().cpu().numpy()
    xs = np.broadcast_to(x0n, (n + 1,) + x0n.shape).copy()
    w, rounds = 0, 0
    while w < n and rounds < max_rounds:
        wlen = min(window, n - w)
        pts = torch.from_numpy(xs[w: w + wlen]).to(dev)
        ts = tgrid[w: w + wlen]
        fs = drift(pts, ts)  # one parallel round (<= `window` cores)
        rounds += 1
        hs = (tgrid[w + 1: w + wlen + 1] - ts).reshape((wlen,)
                                                       + (1,) * x0.ndim)
        new = xs[w] + np.cumsum((hs * fs).cpu().numpy(), axis=0)
        err = _rel_err(torch.from_numpy(new),
                       torch.from_numpy(xs[w + 1: w + wlen + 1])).numpy()
        xs[w + 1: w + wlen + 1] = new
        # slide past the converged prefix
        m = 0
        while m < wlen and err[m] < tol:
            m += 1
        w += m
    return BaselineResult(torch.from_numpy(xs[n]).to(dev), rounds, n)


def srds_sample(drift: DriftFn, x0, tgrid, num_segments: int, tol: float = 1e-3,
                max_iters: int | None = None, device="cuda") -> BaselineResult:
    dev = resolve_device(device)
    tgrid = torch.as_tensor(tgrid).to(dev)
    x0 = torch.as_tensor(x0).to(dev)
    n = int(tgrid.shape[0]) - 1
    m = num_segments
    bounds = [round(j * n / m) for j in range(m + 1)]  # grid indices
    max_iters = max_iters if max_iters is not None else m

    def step(x, i, i_next):
        """x + (t[i_next] - t[i]) * f(x, t[i]) for one latent."""
        return x + (tgrid[i_next] - tgrid[i]) * drift(x[None],
                                                      tgrid[i:i + 1])[0]

    def coarse(x, j):
        return step(x, bounds[j], bounds[j + 1])

    def fine(x, j):  # sequential fine Euler inside segment j
        for i in range(bounds[j], bounds[j + 1]):
            x = step(x, i, i + 1)
        return x

    seg_len = max(bounds[j + 1] - bounds[j] for j in range(m))

    u = [x0] * (m + 1)
    g_cache = [None] * m
    rounds = 0
    for j in range(m):  # init coarse sweep (sequential)
        g_cache[j] = coarse(u[j], j)
        u[j + 1] = g_cache[j]
        rounds += 1

    iters = 0
    for _ in range(max_iters):
        iters += 1
        f_out = [fine(u[j], j) for j in range(m)]  # parallel across cores
        rounds += seg_len
        u_new = [x0] + [None] * m
        g_new = [None] * m
        for j in range(m):  # parareal sequential correction sweep
            g_new[j] = coarse(u_new[j], j)
            u_new[j + 1] = g_new[j] + f_out[j] - g_cache[j]
            rounds += 1
        delta = max(float(_rel_err(u_new[j + 1][None], u[j + 1][None])[0])
                    for j in range(m))
        u, g_cache = u_new, g_new
        if delta < tol:
            break
    return BaselineResult(u[m], rounds, n, iters)
