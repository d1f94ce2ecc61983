"""Noise schedules and drift parameterizations — port of
``repro.diffusion.schedules``.

Paper convention: t=0 noise, t=1 data. Two parameterizations of the PF-ODE
drift f_theta(x, t):

* rectified flow (SD3/Flux/Hunyuan): x_t = (1-t) eps + t x1; drift = v_theta.
* VP/cosine (DDIM-class): x_t = alpha(t) x1 + sigma(t) eps; the DDIM update on
  a uniform grid equals Euler on the drift below, so "euler" + VP == DDIM.

``t`` may be a Python float or a tensor; the trigonometry runs in torch.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RectifiedFlow:
    """x_t = (1-t) eps + t x1. drift(x,t) = v_theta(x,t) (velocity prediction)."""

    def drift_from_velocity(self, v, x, t):
        return v

    def x_t(self, x1, eps, t):
        return (1.0 - t) * eps + t * x1

    def velocity_target(self, x1, eps):
        return x1 - eps


def _t(t):
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class VPCosine:
    """alpha(t) = sin(pi t / 2), sigma(t) = cos(pi t / 2) (t=0 noise -> t=1 data).

    PF-ODE drift from an epsilon-prediction model:
      dx/dt = alpha'(t) x1_hat + sigma'(t) eps_hat,
      x1_hat = (x - sigma eps_hat) / alpha.
    Singular at t=0 (alpha=0); sample on t in [t_min, t_max].
    """

    t_min: float = 0.02

    def alpha(self, t):
        return torch.sin(0.5 * math.pi * _t(t))

    def sigma(self, t):
        return torch.cos(0.5 * math.pi * _t(t))

    def dalpha(self, t):
        return 0.5 * math.pi * torch.cos(0.5 * math.pi * _t(t))

    def dsigma(self, t):
        return -0.5 * math.pi * torch.sin(0.5 * math.pi * _t(t))

    def x_t(self, x1, eps, t):
        return self.alpha(t) * x1 + self.sigma(t) * eps

    def drift_from_eps(self, eps_hat, x, t):
        a, s = self.alpha(t), self.sigma(t)
        x1_hat = (x - s * eps_hat) / torch.clamp(a, min=1e-4)
        return self.dalpha(t) * x1_hat + self.dsigma(t) * eps_hat
