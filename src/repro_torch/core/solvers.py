"""Single-core ODE solver s_theta (paper Eq. 6) — port of
``repro.core.solvers`` (Euler; Heun and the draft drift come later)."""
from __future__ import annotations

import torch

from repro_torch.core.ode import DriftFn
from repro_torch.device import resolve_device


def euler_delta(f_val, t, t_next):
    """Delta for x_{t'} = x_t + (t'-t) f(x_t, t), given precomputed drift."""
    return (t_next - t) * f_val


def sequential_sample(drift: DriftFn, x0, tgrid, method: str = "euler",
                      collect: bool = False, device="cuda"):
    """Golden sequential Euler solve over the full grid. Returns x_1 (or
    ``(x_1, trajectory [N, ...])``). The drift sees one row (``[1, ...]``
    with ``t`` of shape ``[1]``), the port's drift contract."""
    if method != "euler":
        raise NotImplementedError(
            f"method={method!r}: only Euler is ported (Heun comes with the "
            f"paper baselines, ROADMAP.md queue 1 item 10)")
    dev = resolve_device(device)
    x = torch.as_tensor(x0).to(dev)[None]
    tgrid = torch.as_tensor(tgrid).to(dev)
    n = tgrid.shape[0] - 1
    traj = []
    for i in range(n):
        t, tn = tgrid[i:i + 1], tgrid[i + 1:i + 2]
        x = x + (tn - t).reshape((1,) * x.ndim) * drift(x, t)
        if collect:
            traj.append(x[0])
    return (x[0], torch.stack(traj)) if collect else x[0]
