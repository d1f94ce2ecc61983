"""Inter-core rectification r_theta (paper Eq. 3-4) — port of
``repro.core.rectify`` (the homogeneous part; the draft-lane resampling
helpers come with heterogeneous lanes, ROADMAP.md queue 1 item 7).

    r_theta(x_t, x~_t, t, dt) = dt * (f(x_t, t) - f(x~_t, t)) + x_t - x~_t

Both drifts are already computed by the lockstep rounds (the slow core's
current drift and the fast core's snapshot drift), so rectification costs
elementwise math and one latent transfer, never an extra network call.
``repro_torch.kernels.rectify`` fuses it with the solver step on the card.
"""
from __future__ import annotations

import torch


def rectify_delta(x_slow, f_slow, x_snap, f_snap, dt):
    """The rectification term r_theta, from precomputed drifts."""
    return dt * (f_slow - f_snap) + (x_slow - x_snap)


def rectified_step(x, f, t, t_next, x_slow, f_slow, x_snap, f_snap, t_snap,
                   fire):
    """Fused: Delta = (t'-t) f [+ r_theta if fire]; returns (x_new, Delta)."""
    delta = (t_next - t) * f
    rect = rectify_delta(x_slow, f_slow, x_snap, f_snap, t_next - t_snap)
    delta = torch.where(torch.as_tensor(fire, device=delta.device),
                        delta + rect, delta)
    return x + delta, delta
