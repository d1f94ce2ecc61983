"""CHORDS (paper Algorithm 1) — port of ``repro.core.chords``, homogeneous
part.

One lockstep round = one drift evaluation on every core. The port runs the
round over a ``[G, K, ...]`` grid — G slots (1 for ``chords_sample``), K
cores — and hands the drift all ``G*K`` rows at once with a per-row time
(the drift contract in :mod:`repro_torch.core.ode`), where the JAX package
vmaps a scalar-time drift over cores and slots. The inter-core transfer
(``jnp.roll`` over the cores axis inside the per-slot vmap) is a roll over
dim 1 here.

The final core's trajectory is untouched by rectification, so K == 1 is
bit-identical to ``solvers.sequential_sample`` (tested invariant).
Heterogeneous lanes (``lane_profile``, ``LaneState``) are not ported yet:
ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scheduler
from repro_torch.core.ode import DriftFn
from repro_torch.device import resolve_device


class ChordsCarry(NamedTuple):
    """Per-core lockstep state. Leading axes ``[G, K, ...]`` (``p`` is
    ``[G, K]``); ``chords_sample`` runs with G = 1."""

    x: torch.Tensor       # current latent per core
    x_snap: torch.Tensor  # latent snapshot at the core's snapshot position
    f_snap: torch.Tensor  # drift recorded at the snapshot position
    p: torch.Tensor       # snapshot position per core (int32)
    finals: torch.Tensor  # emitted outputs (written when a core reaches t=1)


@dataclasses.dataclass
class ChordsResult:
    outputs: torch.Tensor  # [K, ...] core outputs, index 0 = sequential
    emit_rounds: np.ndarray  # [K] 1-based lockstep round of each output
    n_steps: int
    trace: Optional[torch.Tensor] = None  # [N, K, ...] latent per round

    def speedup(self, k: int) -> float:
        """Paper speedup metric for accepting core k's (0-based) output."""
        return self.n_steps / float(self.emit_rounds[k])


def bmask(mask, x):
    """Broadcast a leading-axes mask over the trailing latent dims of x."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def accept_test(out, prev, rtol, batch_ndim: int = 0):
    """Consecutive-arrival agreement test (paper §5 "diffusion streaming"):
    ``||out - prev|| / (||out|| + eps) < rtol`` with norms over all but the
    leading ``batch_ndim`` axes. ``rtol`` may be a float or a tensor
    broadcastable to the batch."""
    axes = tuple(range(batch_ndim, out.ndim))
    num = torch.sqrt(torch.sum((out - prev) ** 2, dim=axes))
    den = torch.sqrt(torch.sum(out * out, dim=axes)) + 1e-12
    return num / den < rtol


def accept_from_sums(err_sq, out_sq, rtol):
    """:func:`accept_test` from its pre-reduced sums (the fused kernel's
    outputs); the sqrt/divide/compare tail is op for op the same."""
    return torch.sqrt(err_sq) / (torch.sqrt(out_sq) + 1e-12) < rtol


def _make_round_step(drift: DriftFn, tgrid, n: int, k: int,
                     use_kernel: bool = False, fuse_accept: bool = False):
    """One lockstep round over a ``[G, K, ...]`` grid.

    Returns ``step(carry, i_arr, r) -> (carry, emitted)`` with ``i_arr``
    ``[G, K]`` and ``r`` ``[G]`` (each slot's own round). ``use_kernel``
    routes the fused solver-step + rectification update through
    ``repro_torch.kernels.rectify`` (the CUDA kernel on the card, its
    bitwise-identical plain version on the CPU). ``fuse_accept`` adds the
    ``prev`` operand (``[G, ...]``, the slot's previous streamed output)
    and returns ``(carry, (emitted, err_sq, out_sq))`` with ``[G, K]`` accept
    sums reduced in the same kernel pass.
    """
    from repro_torch.kernels.rectify.ops import (step_rectify,
                                                 step_rectify_accept)
    k0 = torch.arange(k, device=tgrid.device)

    def _common(carry: ChordsCarry, i_arr, r):
        x, x_snap, f_snap, p, finals = carry
        g = x.shape[0]
        cur, nxt = scheduler.positions(i_arr, r)        # [G, K]
        alive = cur <= n - 1
        t_cur = tgrid[cur.clamp(0, n).long()]
        t_nxt = tgrid[nxt.clamp(0, n).long()]
        f = drift(x.reshape((g * k,) + x.shape[2:]),
                  t_cur.reshape(g * k)).reshape(x.shape)

        # snapshot refresh: core is sitting exactly on its snapshot position
        at_snap = (cur == p) & alive
        x_snap = torch.where(bmask(at_snap, x), x, x_snap)
        f_snap = torch.where(bmask(at_snap, f), f, f_snap)

        # rectification: previous core sits on this core's snapshot position
        x_up = torch.roll(x, 1, dims=1)
        f_up = torch.roll(f, 1, dims=1)
        cur_up = torch.roll(cur, 1, dims=1)
        fire = (k0 > 0) & (cur_up == p) & alive
        t_p = tgrid[p.clamp(0, n).long()]
        return (x, x_snap, f_snap, p, finals, f, x_up, f_up,
                nxt, alive, fire, t_cur, t_nxt, t_p)

    def _flat(*ts):
        return [t.reshape((-1,) + t.shape[2:]) for t in ts]

    def _finish(x, x_new, x_snap, f_snap, p, finals, nxt, alive, fire):
        x_snap = torch.where(bmask(fire, x_new), x_new, x_snap)
        p = torch.where(fire, nxt, p)
        x = torch.where(bmask(alive, x_new), x_new, x)
        emitted = (nxt == n) & alive
        finals = torch.where(bmask(emitted, x), x, finals)
        return ChordsCarry(x, x_snap, f_snap, p, finals), emitted

    def step(carry: ChordsCarry, i_arr, r):
        (x, x_snap, f_snap, p, finals, f, x_up, f_up,
         nxt, alive, fire, t_cur, t_nxt, t_p) = _common(carry, i_arr, r)
        x_new = step_rectify(*_flat(x, f, x_up, f_up, x_snap, f_snap),
                             *_flat(t_nxt - t_cur, t_nxt - t_p, fire),
                             use_kernel=use_kernel).reshape(x.shape)
        return _finish(x, x_new, x_snap, f_snap, p, finals, nxt, alive, fire)

    def step_accept(carry: ChordsCarry, i_arr, r, prev):
        (x, x_snap, f_snap, p, finals, f, x_up, f_up,
         nxt, alive, fire, t_cur, t_nxt, t_p) = _common(carry, i_arr, r)
        x_new, err_sq, out_sq = step_rectify_accept(
            *_flat(x, f, x_up, f_up, x_snap, f_snap), prev.to(x.dtype),
            *_flat(t_nxt - t_cur, t_nxt - t_p, fire), use_kernel=use_kernel)
        new_carry, emitted = _finish(x, x_new.reshape(x.shape), x_snap,
                                     f_snap, p, finals, nxt, alive, fire)
        g = x.shape[0]
        return new_carry, (emitted, err_sq.reshape(g, k),
                           out_sq.reshape(g, k))

    return step_accept if fuse_accept else step


def make_round_body(drift: DriftFn, tgrid, i_arr, n: int, k: int,
                    collect_trace: bool = False, use_kernel: bool = False):
    """One lockstep round of Algorithm 1 over a ``[K, ...]`` grid (shared by
    the batch sampler and the streaming engine). carry = ChordsCarry with
    ``[K, ...]`` leaves; ``r`` is the scalar round."""
    step = _make_round_step(drift, tgrid, n, k, use_kernel=use_kernel)
    i_g = torch.as_tensor(i_arr, dtype=torch.int32,
                          device=tgrid.device)[None]

    def round_body(carry: ChordsCarry, r):
        grid = ChordsCarry(*(t[None] for t in carry))
        r_g = torch.as_tensor([r], dtype=torch.int32, device=tgrid.device)
        new, emitted = step(grid, i_g, r_g)
        new_carry = ChordsCarry(*(t[0] for t in new))
        trace = new_carry.x if collect_trace else emitted[0]
        return new_carry, trace

    return round_body


def make_slot_round_body(drift: DriftFn, tgrid, n: int, k: int,
                         use_kernel: bool = False, fuse_accept: bool = False,
                         lane_profile=None):
    """One lockstep round over a fixed ``[S, K, ...]`` slot x core grid.

    Returns ``slot_round(carry, i_arr, r, live) -> (carry, emitted)``; with
    ``fuse_accept`` ``slot_round(carry, i_arr, r, live, prev) -> (carry,
    emitted, err_sq, out_sq)``. Dead (``~live``) lanes still evaluate the
    drift (the grid is static) but their carry is frozen; dead-lane sums
    are garbage that callers gate off with the live/emitted masks.
    """
    if lane_profile is not None:
        raise NotImplementedError(
            "lane_profile (heterogeneous lanes) is not ported yet: "
            "ROADMAP.md queue 1 item 7")
    step = _make_round_step(drift, tgrid, n, k, use_kernel=use_kernel,
                            fuse_accept=fuse_accept)

    def _freeze(new_carry, carry, live):
        return ChordsCarry(*(torch.where(bmask(live, new), new, old)
                             for new, old in zip(new_carry, carry)))

    if fuse_accept:
        def slot_round_accept(carry: ChordsCarry, i_arr, r, live, prev):
            new_carry, (emitted, err_sq, out_sq) = step(carry, i_arr, r,
                                                        prev)
            return (_freeze(new_carry, carry, live), emitted & live[:, None],
                    err_sq, out_sq)

        return slot_round_accept

    def slot_round(carry: ChordsCarry, i_arr, r, live):
        new_carry, emitted = step(carry, i_arr, r)
        return _freeze(new_carry, carry, live), emitted & live[:, None]

    return slot_round


def chords_init_carry(x0, i_arr, k: int) -> ChordsCarry:
    x = x0.expand((k,) + x0.shape).clone()
    return ChordsCarry(x=x, x_snap=x.clone(), f_snap=torch.zeros_like(x),
                       p=torch.as_tensor(i_arr, dtype=torch.int32,
                                         device=x0.device).clone(),
                       finals=torch.zeros_like(x))


def slot_init_carry(num_slots: int, k: int, latent_shape,
                    dtype=torch.float32, device="cpu") -> ChordsCarry:
    """Empty [S, K, ...] grid — every lane dead until ``reset_slots``."""
    z = torch.zeros((num_slots, k) + tuple(latent_shape), dtype=dtype,
                    device=device)
    return ChordsCarry(x=z, x_snap=z.clone(), f_snap=z.clone(),
                       p=torch.zeros((num_slots, k), dtype=torch.int32,
                                     device=device),
                       finals=z.clone())


def reset_slots(carry: ChordsCarry, mask, x0, i_arr) -> ChordsCarry:
    """Re-initialize masked slot lanes (admission). mask: [S] bool; x0:
    [S, ...] fresh noise (rows read only where mask); i_arr: [S, K]."""
    k = carry.p.shape[-1]
    x = x0[:, None].expand((x0.shape[0], k) + x0.shape[1:]) \
        .to(carry.x.dtype)
    m = bmask(mask, carry.x)
    zero = torch.zeros((), dtype=carry.x.dtype, device=carry.x.device)
    return ChordsCarry(
        x=torch.where(m, x, carry.x),
        x_snap=torch.where(m, x, carry.x_snap),
        f_snap=torch.where(m, zero, carry.f_snap),
        p=torch.where(mask[:, None], i_arr.to(torch.int32), carry.p),
        finals=torch.where(m, zero, carry.finals),
    )


def chords_sample(drift: DriftFn, x0, tgrid, i_seq: Sequence[int],
                  collect_trace: bool = False,
                  device="cuda") -> ChordsResult:
    """Run Algorithm 1 for all N rounds; returns every core's output.

    drift: the port's row drift (:mod:`repro_torch.core.ode`); x0: noise
    latent (any shape); tgrid: [N+1]; i_seq: increasing ints, i[0]=0.
    """
    dev = resolve_device(device)
    x0 = torch.as_tensor(x0).to(dev)
    tgrid = torch.as_tensor(tgrid).to(dev)
    n = int(tgrid.shape[0]) - 1
    k = len(i_seq)
    if list(i_seq)[0] != 0 or any(b <= a for a, b in zip(i_seq, i_seq[1:])):
        raise ValueError(f"i_seq must be strictly increasing from 0: {i_seq}")
    if i_seq[-1] >= n:
        raise ValueError(f"i_seq {i_seq} exceeds n_steps {n}")
    i_arr = torch.as_tensor(list(i_seq), dtype=torch.int32, device=dev)
    round_body = make_round_body(drift, tgrid, i_arr, n, k, collect_trace)
    carry = chords_init_carry(x0, i_arr, k)
    trace = []
    for r in range(1, n + 1):
        carry, tr = round_body(carry, r)
        if collect_trace:
            trace.append(tr)
    return ChordsResult(outputs=carry.finals,
                        emit_rounds=scheduler.emit_rounds(list(i_seq), n),
                        n_steps=n,
                        trace=torch.stack(trace) if collect_trace else None)


def select_output(result: ChordsResult, rtol: float = 0.05):
    """Streaming early-exit: accept the first output that agrees with its
    predecessor arrival within rtol. Outputs arrive fastest-first (core
    K-1, K-2, ...). Returns (accepted_core_index, rounds_used, speedup).

    The test runs in f32 on the host, as the JAX package's does (its f64
    host copy is cast back to f32 by ``jnp`` with x64 off).
    """
    outs = result.outputs.detach().to("cpu", torch.float32)
    k = outs.shape[0]
    order = list(range(k - 1, -1, -1))  # arrival order: core K-1 first
    prev = None
    for core in order:
        if prev is not None and bool(accept_test(outs[core], outs[prev],
                                                 rtol)):
            r = int(result.emit_rounds[core])
            return core, r, result.n_steps / r
        prev = core
    return 0, int(result.emit_rounds[0]), 1.0
