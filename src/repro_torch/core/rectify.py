"""Inter-core rectification r_theta (paper Eq. 3-4) — port of
``repro.core.rectify``, with the draft lanes' resampling helpers.

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


# -- coarse <-> fine latent resampling (heterogeneous draft lanes) -----------
#
# Draft lanes run the drift at reduced latent resolution: the latent is
# avg-pooled along its innermost axis before the network call and the
# velocity is expanded back. The pair preserves shape for any last-axis
# length (edge padding to a factor multiple), so draft lanes differ from
# refine lanes only by this masked smoothing, never by shape.

def downsample_latent(x, factor: int):
    """Avg-pool the innermost latent axis by ``factor`` (edge-padded)."""
    if factor <= 1:
        return x
    length = x.shape[-1]
    pad = (-length) % factor
    if pad:
        x = torch.cat([x, x[..., -1:].expand(x.shape[:-1] + (pad,))], dim=-1)
    coarse = (length + pad) // factor
    x = x.reshape(x.shape[:-1] + (coarse, factor))
    # the reference's mean as XLA computes it: a left-to-right sum times
    # the reciprocal of the factor (bitwise for every factor)
    acc = x[..., 0]
    for i in range(1, factor):
        acc = acc + x[..., i]
    return acc * (1.0 / factor)


def upsample_latent(x, factor: int, length: int):
    """Nearest-neighbor expand of the innermost axis back to ``length``."""
    if factor <= 1:
        return x
    return torch.repeat_interleave(x, factor, dim=-1)[..., :length]


def coarse_smooth(x, factor: int):
    """``downsample_latent`` then ``upsample_latent``: the reduced-resolution
    view of ``x`` at its original shape (identity for ``factor <= 1``)."""
    return upsample_latent(downsample_latent(x, factor), factor, x.shape[-1])
