"""PF-ODE helpers — port of ``repro.core.ode``.

Convention (paper footnote 1): t=0 is noise, t=1 is data; we solve
``dx = f_theta(x, t) dt`` forward from x_0 ~ N(0, I).

**Drift contract of the port.** A drift is ``drift(x, t)`` with ``x`` of
shape ``[R, *latent]`` — R independent evaluations, e.g. every core of every
slot — and ``t`` of shape ``[R]``, one time per row. The JAX package vmaps a
scalar-``t`` drift over cores and slots instead; here the rows are one
batch, so a round costs one backbone call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

# drift: (x [R, ...], t [R]) -> dx/dt [R, ...]
DriftFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exponential_drift(x, t):
    return x


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Rectified-flow marginal velocity field for data ~ sum_i w_i
    N(mu_i, sig_i^2 I) (closed form; tests build it from the JAX one's
    arrays)."""

    mus: torch.Tensor  # [M, D]
    sigmas: torch.Tensor  # [M]
    weights: torch.Tensor  # [M]

    def to(self, device) -> "GaussianMixture":
        return GaussianMixture(self.mus.to(device), self.sigmas.to(device),
                               self.weights.to(device))

    def drift(self, x, t):
        """x: [R, ..., D]; t: [R] (or a scalar), each row's time in [0, 1)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        # per-row t broadcast over the row's trailing latent axes but D
        t = t.reshape(t.shape + (1,) * (x.ndim - 1 - t.ndim))[..., None]
        d = x.shape[-1]
        s2 = (1.0 - t) ** 2 + (t * self.sigmas) ** 2  # [..., M]
        diff = x[..., None, :] - t[..., None] * self.mus  # [..., M, D]
        logr = (torch.log(self.weights)
                - 0.5 * torch.sum(diff ** 2, -1) / s2
                - 0.5 * d * torch.log(s2))
        r = torch.softmax(logr, dim=-1)  # [..., M]
        coef = (t * self.sigmas ** 2 - (1.0 - t)) / s2  # [..., M]
        v_i = self.mus + coef[..., None] * diff  # [..., M, D]
        return torch.sum(r[..., None] * v_i, dim=-2)


def uniform_tgrid(n_steps: int, t_max: float = 1.0,
                  device="cpu") -> torch.Tensor:
    """t(i) = i/N * t_max, f32, bitwise the values ``jnp.linspace`` gives.

    The JAX package's grid is ``jnp.linspace(0, t_max, N+1)``, which XLA
    compiles to ``i * (t_max * (1/N))`` in f32 with the endpoint pinned to
    ``t_max``. ``torch.linspace`` (and a literal ``i/N * t_max``) differ
    from it in the last ulp for many N, so the grid is built here in XLA's
    association; the tests hold the two grids bitwise equal.
    """
    f32 = np.float32
    step = f32(t_max) * (f32(1.0) / f32(n_steps))
    grid = np.arange(n_steps + 1, dtype=f32) * step
    grid[-1] = f32(t_max)
    return torch.from_numpy(grid).to(device)
