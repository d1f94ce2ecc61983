"""Single-core ODE solvers s_theta (paper Eq. 6) — port of
``repro.core.solvers``.

``euler`` on the rectified-flow parameterization is exactly the DDIM update
in the paper's time variable, so it is the default; ``heun`` (2 NFE a
step) is the second-order solver of the convergence-order tests."""
from __future__ import annotations

import torch

from repro_torch.core.ode import DriftFn
from repro_torch.device import resolve_device


def euler_delta(f_val, t, t_next):
    """Delta for x_{t'} = x_t + (t'-t) f(x_t, t), given precomputed drift."""
    return (t_next - t) * f_val


def sequential_sample(drift: DriftFn, x0, tgrid, method: str = "euler",
                      collect: bool = False, device="cuda"):
    """Golden sequential solve over the full grid (``euler`` or ``heun``).
    Returns x_1 (or ``(x_1, trajectory [N, ...])``). The drift sees one row
    (``[1, ...]`` with ``t`` of shape ``[1]``), the port's drift contract."""
    if method not in ("euler", "heun"):
        raise KeyError(method)
    dev = resolve_device(device)
    x = torch.as_tensor(x0).to(dev)[None]
    tgrid = torch.as_tensor(tgrid).to(dev)
    n = tgrid.shape[0] - 1
    traj = []
    for i in range(n):
        t, tn = tgrid[i:i + 1], tgrid[i + 1:i + 2]
        h = (tn - t).reshape((1,) * x.ndim)
        f1 = drift(x, t)
        if method == "euler":
            x = x + h * f1
        else:
            f2 = drift(x + h * f1, tn)
            x = x + h * 0.5 * (f1 + f2)
        if collect:
            traj.append(x[0])
    return (x[0], torch.stack(traj)) if collect else x[0]


def nfe_per_step(method: str) -> int:
    return {"euler": 1, "heun": 2}[method]


def draft_drift(drift: DriftFn, coarse_factor: int) -> DriftFn:
    """Cheap draft-solver drift: evaluate at reduced latent resolution.

    Wraps ``drift`` in the ``rectify.coarse_smooth`` down/up-sample pair:
    the latent is smoothed before the network call and the velocity after.
    Shape-preserving, 1 NFE, and exactly the per-core computation the
    heterogeneous round applies under its draft mask
    (``core.chords.make_slot_round_body`` with a lane profile); kept
    standalone as the plain version that masked path is tested against.
    """
    from repro_torch.core.rectify import coarse_smooth

    if coarse_factor <= 1:
        return drift

    def cheap(x, t):
        return coarse_smooth(drift(coarse_smooth(x, coarse_factor), t),
                             coarse_factor)

    return cheap
