"""CHORDS (paper Algorithm 1) — port of ``repro.core.chords``.

One lockstep round = one drift evaluation on every core. The port runs the
round over a ``[G, K, ...]`` grid — G slots (1 for ``chords_sample``), K
cores — and hands the drift all ``G*K`` rows at once with a per-row time
(the drift contract in :mod:`repro_torch.core.ode`), where the JAX package
vmaps a scalar-time drift over cores and slots. The inter-core transfer
(``jnp.roll`` over the cores axis inside the per-slot vmap) is a roll over
dim 1 here.

The final core's trajectory is untouched by rectification, so K == 1 is
bit-identical to ``solvers.sequential_sample`` (tested invariant).

Heterogeneous lanes (``lane_profile``, a tuple of :class:`LaneSpec`): a
slot's K cores become asymmetric. Draft-role lanes evaluate the drift on
the coarse-smoothed latent (``rectify.coarse_smooth``) and every
skip-eligible lane keeps a stability statistic (:class:`LaneState`) that
gates an Euler double step once the trajectory settles. Both are
``torch.where`` masks over the same static grid: the per-request gates
(``draft_on``/``skip_tau``) select the behavior at run time, no decision
leaves the device inside a round, and all-false gates give the
homogeneous round bitwise. :func:`gather_slots` copies whole lanes between
grids of different slot counts (elastic resize).

On a mesh (an ambient ``use_sharding`` context and DTensor state) the
reference's ``vmap_logical`` sites hold its meaning: the slot round is
lifted over ``slots`` and runs on each rank's block of slots
(``dist.sharding.on_blocks``), and the drift is lifted over ``cores``, its
rows put back on the mesh (``lift_rows``, rows slot-major, Shard(0) on the
slots' mesh axes) so that its parameters are tensor-parallel over the
others. Where no slot axis takes a mesh axis (:func:`make_round_body`:
``chords_sample``, the stream program) the cores ride it instead: each
rank runs its block of cores, and the inter-core rolls become ring shifts
that move one boundary core a rank (``roll_blocks``), the counterpart of
the reference's collective-permute.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler
from repro_torch.core.ode import DriftFn
from repro_torch.core.rectify import coarse_smooth
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (block_offset, lift_rows, on_blocks,
                                       roll_blocks, vmap_logical)

# EMA weight of the per-lane stability statistic (relative drift-norm
# delta): ~2 rounds of memory. The skip threshold is per request
# (``LaneState.skip_tau``).
STAB_ALPHA = 0.5


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """Static per-core lane role inside one slot (hashable: rides GridSpec).

    role: "refine" evaluates the exact drift; "draft" evaluates it at
        reduced resolution (``coarse_factor``-pooled innermost latent axis)
        when the resident request opted in (``draft_on`` gate).
    skip: the lane may take stability-gated double steps (armed per request
        by a nonzero ``skip_tau``). Core 0 must stay ``refine``/no-skip: it
        anchors the sequential-exactness guarantee (rtol <= 0
        force-accept) in every mode.
    """

    role: str = "refine"
    coarse_factor: int = 1
    skip: bool = False


def default_lane_profile(k: int) -> Tuple[LaneSpec, ...]:
    """The standard profile: the fastest ~quarter of the cores are draft
    lanes (coarse factor 2), the fast half is skip-eligible, and the slow
    half, core 0 included, stays exact refine."""
    if k <= 1:
        return (LaneSpec(),)
    n_draft = max(1, k // 4)
    return tuple(
        LaneSpec(role="draft" if c >= k - n_draft else "refine",
                 coarse_factor=2 if c >= k - n_draft else 1,
                 skip=c >= (k + 1) // 2)
        for c in range(k))


class LaneState(NamedTuple):
    """Per-lane heterogeneous state riding next to ChordsCarry: ``[S, K]``
    per core, ``[S]`` per-slot gates."""

    pos: torch.Tensor       # [S, K] int32 — committed skip-advance offset
    f_norm: torch.Tensor    # [S, K] f32 — last drift norm (0 = none yet)
    stab: torch.Tensor      # [S, K] f32 — drift-delta EMA (1 = unsettled)
    skips: torch.Tensor     # [S, K] int32 — committed skips this residency
    draft_on: torch.Tensor  # [S] bool — request opted into draft smoothing
    skip_tau: torch.Tensor  # [S] f32 — skip threshold; 0 disables skipping


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
    k_all = torch.arange(k, device=tgrid.device)
    vdrift = vmap_logical(lift_rows(drift), "cores")

    def _common(carry: ChordsCarry, i_arr, r):
        x, x_snap, f_snap, p, finals = carry
        g, kl = x.shape[0], x.shape[1]  # kl: this rank's cores
        k0 = _core_ids(k_all, kl)
        cur, nxt = _positions(i_arr, r, kl)             # [G, K]
        alive = cur <= n - 1
        t_cur = tgrid[cur.clamp(0, n).long()]
        t_nxt = tgrid[nxt.clamp(0, n).long()]
        f = vdrift(x.reshape((g * kl,) + x.shape[2:]),
                   t_cur.reshape(g * kl)).reshape(x.shape)

        # snapshot refresh: core is sitting exactly on its snapshot position
        at_snap = (cur == p) & alive
        x_snap = torch.where(bmask(at_snap, x), x, x_snap)
        f_snap = torch.where(bmask(at_snap, f), f, f_snap)

        # rectification: previous core sits on this core's snapshot position
        x_up = roll_blocks(x, 1, 1, "cores")
        f_up = roll_blocks(f, 1, 1, "cores")
        cur_up = roll_blocks(cur, 1, 1, "cores")
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
        return new_carry, (emitted, err_sq.reshape(g, -1),
                           out_sq.reshape(g, -1))

    return step_accept if fuse_accept else step


def _core_ids(k_all, kl: int):
    """Global indices of this rank's ``kl`` cores (all K off a mesh)."""
    return k_all.narrow(0, block_offset("cores", kl), kl)


def _positions(i_arr, r, kl: int):
    """``scheduler.positions`` of every core (a core's position reads the
    whole init sequence), narrowed to this rank's ``kl`` cores."""
    cur, nxt = scheduler.positions(i_arr, r)
    if cur.shape[-1] == kl:
        return cur, nxt
    off = block_offset("cores", kl)
    return cur.narrow(-1, off, kl), nxt.narrow(-1, off, kl)


def _check_profile(profile, k: int) -> int:
    """Validate a lane profile for K cores; returns the draft factor."""
    if len(profile) != k:
        raise ValueError(f"lane profile has {len(profile)} specs for K={k}")
    if profile[0].role != "refine" or profile[0].skip:
        raise ValueError("core 0 must be a refine/no-skip lane: it anchors "
                         "the sequential-exactness guarantee")
    factors = {sp.coarse_factor for sp in profile if sp.role == "draft"}
    if len(factors) > 1:
        raise ValueError(f"draft lanes must share one coarse_factor: "
                         f"{sorted(factors)}")
    return factors.pop() if factors else 1


def _make_lane_round_step(drift: DriftFn, tgrid, n: int, k: int,
                          profile: Sequence[LaneSpec],
                          use_kernel: bool = False,
                          fuse_accept: bool = False):
    """Heterogeneous-lane variant of :func:`_make_round_step`:
    ``step(carry, lanes, i_arr, r) -> ((carry, lanes), emitted)`` (and the
    ``fuse_accept`` twin taking ``prev``). Three masks over the homogeneous
    round, all selects on one static program:

    * skip offset: ``lanes.pos`` counts committed double steps, so a lane's
      position is ``scheduler.positions(...) + pos``; a skip replaces
      ``nxt = cur + 1`` with ``cur + 2``, one Euler step over two cells
      through the same step operands;
    * draft smoothing: draft-role lanes (gate ``draft_on``) see the
      coarse-smoothed latent and emit the coarse-smoothed drift, one drift
      evaluation either way;
    * stability gate: skip only when the drift-delta EMA is below the
      request's ``skip_tau`` and the hop is safe (fine phase, in grid, not
      a rectification round, never over the lane's own snapshot position
      or the downstream lane's).

    With both gates off every select takes its exact operand: the
    homogeneous round bitwise (``mode="exact"``).
    """
    from repro_torch.kernels.rectify.ops import (step_rectify,
                                                 step_rectify_accept)
    profile = tuple(profile)
    factor = _check_profile(profile, k)
    dev = tgrid.device
    draft_all = torch.tensor([sp.role == "draft" for sp in profile],
                             device=dev)
    skip_all = torch.tensor([bool(sp.skip) for sp in profile], device=dev)
    k_all = torch.arange(k, device=dev)
    vdrift = vmap_logical(lift_rows(drift), "cores")

    def _common(carry: ChordsCarry, lanes: LaneState, i_arr, r):
        x, x_snap, f_snap, p, finals = carry
        g, kl = x.shape[0], x.shape[1]  # kl: this rank's cores
        off = block_offset("cores", kl)
        k0 = k_all.narrow(0, off, kl)
        draft_role = draft_all.narrow(0, off, kl)
        skip_role = skip_all.narrow(0, off, kl)
        base_cur, base_nxt = _positions(i_arr, r, kl)        # [G, K]
        cur = base_cur + lanes.pos
        nxt = base_nxt + lanes.pos
        alive = cur <= n - 1
        t_cur = tgrid[cur.clamp(0, n).long()]

        # draft lanes: drift of/at the coarse-smoothed latent (one eval)
        draft_m = draft_role & lanes.draft_on[:, None] & alive
        x_eval = torch.where(bmask(draft_m, x), coarse_smooth(x, factor), x)
        f_raw = vdrift(x_eval.reshape((g * kl,) + x.shape[2:]),
                       t_cur.reshape(g * kl)).reshape(x.shape)
        f = torch.where(bmask(draft_m, f_raw), coarse_smooth(f_raw, factor),
                        f_raw)

        # stability statistic: EMA of the relative drift-norm delta between
        # consecutive rounds (1.0 until two norms are seen)
        f_mag = torch.sqrt(torch.sum(torch.square(f.to(torch.float32)),
                                     dim=tuple(range(2, x.ndim))))
        rel = torch.where(lanes.f_norm > 0.0,
                          torch.abs(f_mag - lanes.f_norm) / (f_mag + 1e-6),
                          1.0)
        stab = torch.where(alive,
                           STAB_ALPHA * rel + (1.0 - STAB_ALPHA) * lanes.stab,
                           lanes.stab)
        f_norm = torch.where(alive, f_mag, lanes.f_norm)

        # snapshot refresh: core is sitting exactly on its snapshot position
        at_snap = (cur == p) & alive
        x_snap = torch.where(bmask(at_snap, x), x, x_snap)
        f_snap = torch.where(bmask(at_snap, f), f, f_snap)

        # rectification: previous core sits on this core's snapshot position
        x_up = roll_blocks(x, 1, 1, "cores")
        f_up = roll_blocks(f, 1, 1, "cores")
        cur_up = roll_blocks(cur, 1, 1, "cores")
        fire = (k0 > 0) & (cur_up == p) & alive

        # stability-gated double step (fine phase only; nxt < n keeps the
        # hop in grid; hopping p or p_down would strand a snapshot position)
        fine = r[:, None] > k0
        p_down = roll_blocks(p, -1, 1, "cores")
        tau = lanes.skip_tau[:, None]
        skip = (skip_role & (tau > 0.0) & (stab < tau) & fine & alive
                & ~fire & (nxt < n) & (cur + 1 != p) & (cur + 1 != p_down))
        nxt = torch.where(skip, cur + 2, nxt)

        t_nxt = tgrid[nxt.clamp(0, n).long()]
        t_p = tgrid[p.clamp(0, n).long()]
        skip32 = skip.to(torch.int32)
        new_lanes = LaneState(pos=lanes.pos + skip32, f_norm=f_norm,
                              stab=stab, skips=lanes.skips + skip32,
                              draft_on=lanes.draft_on,
                              skip_tau=lanes.skip_tau)
        return (x, x_snap, f_snap, p, finals, f, x_up, f_up,
                nxt, alive, fire, t_cur, t_nxt, t_p, new_lanes)

    def _flat(*ts):
        return [t.reshape((-1,) + t.shape[2:]) for t in ts]

    def _finish(x, x_new, x_snap, f_snap, p, finals, nxt, alive, fire):
        x_snap = torch.where(bmask(fire, x_new), x_new, x_snap)
        p = torch.where(fire, nxt, p)
        x = torch.where(bmask(alive, x_new), x_new, x)
        emitted = (nxt == n) & alive
        finals = torch.where(bmask(emitted, x), x, finals)
        return ChordsCarry(x, x_snap, f_snap, p, finals), emitted

    def step(carry: ChordsCarry, lanes: LaneState, i_arr, r):
        (x, x_snap, f_snap, p, finals, f, x_up, f_up, nxt, alive, fire,
         t_cur, t_nxt, t_p, new_lanes) = _common(carry, lanes, i_arr, r)
        x_new = step_rectify(*_flat(x, f, x_up, f_up, x_snap, f_snap),
                             *_flat(t_nxt - t_cur, t_nxt - t_p, fire),
                             use_kernel=use_kernel).reshape(x.shape)
        new_carry, emitted = _finish(x, x_new, x_snap, f_snap, p, finals,
                                     nxt, alive, fire)
        return (new_carry, new_lanes), emitted

    def step_accept(carry: ChordsCarry, lanes: LaneState, i_arr, r, prev):
        (x, x_snap, f_snap, p, finals, f, x_up, f_up, nxt, alive, fire,
         t_cur, t_nxt, t_p, new_lanes) = _common(carry, lanes, i_arr, r)
        x_new, err_sq, out_sq = step_rectify_accept(
            *_flat(x, f, x_up, f_up, x_snap, f_snap), prev.to(x.dtype),
            *_flat(t_nxt - t_cur, t_nxt - t_p, fire), use_kernel=use_kernel)
        new_carry, emitted = _finish(x, x_new.reshape(x.shape), x_snap,
                                     f_snap, p, finals, nxt, alive, fire)
        g = x.shape[0]
        return (new_carry, new_lanes), (emitted, err_sq.reshape(g, -1),
                                        out_sq.reshape(g, -1))

    return step_accept if fuse_accept else step


def make_round_body(drift: DriftFn, tgrid, i_arr, n: int, k: int,
                    collect_trace: bool = False, use_kernel: bool = False):
    """One lockstep round of Algorithm 1 over a ``[K, ...]`` grid (shared by
    the batch sampler and the streaming engine). carry = ChordsCarry with
    ``[K, ...]`` leaves; ``r`` is the round: a Python int or a 0-d int32
    tensor on the device (the stream program's counter, which never comes
    back to the host).

    On a mesh (DTensor carry under ``use_sharding``) the cores axis takes
    its mesh axis: each rank runs its block of cores and the rolls move
    one boundary core to the next rank (:func:`dist.sharding.on_blocks`,
    ``roll_blocks``); the outputs lead with the cores, laid out so."""
    step = _make_round_step(drift, tgrid, n, k, use_kernel=use_kernel)
    i_all = torch.as_tensor(i_arr, dtype=torch.int32, device=tgrid.device)

    def local_round(carry: ChordsCarry, i_seq, r):
        grid = ChordsCarry(*(t[None] for t in carry))
        r_g = torch.as_tensor(r, dtype=torch.int32,
                              device=tgrid.device).reshape(1)
        new, emitted = step(grid, i_seq[None], r_g)
        new_carry = ChordsCarry(*(t[0] for t in new))
        trace = new_carry.x if collect_trace else emitted[0]
        return new_carry, trace

    blocked = on_blocks(local_round, "cores", in_axes=(0, None, None))

    def round_body(carry: ChordsCarry, r):
        return blocked(carry, i_all, r)

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

    With a ``lane_profile`` the round is the heterogeneous variant
    (:func:`_make_lane_round_step`): a :class:`LaneState` rides next to the
    carry in second position of both signatures,
    ``lane_round(carry, lanes, i_arr, r, live[, prev]) -> (carry, lanes,
    emitted[, err_sq, out_sq])``, and dead lanes freeze it too.

    Every argument and output leads with the slots, and the round is
    lifted over them (``vmap_logical(..., "slots")``): on a mesh each rank
    runs its own slots.
    """
    return vmap_logical(_slot_round_body(drift, tgrid, n, k, use_kernel,
                                         fuse_accept, lane_profile), "slots")


def _slot_round_body(drift, tgrid, n, k, use_kernel, fuse_accept,
                     lane_profile):
    def _freeze(new, old, live):
        return type(old)(*(torch.where(bmask(live, a), a, b)
                           for a, b in zip(new, old)))

    if lane_profile is not None:
        lstep = _make_lane_round_step(drift, tgrid, n, k, lane_profile,
                                      use_kernel=use_kernel,
                                      fuse_accept=fuse_accept)

        if fuse_accept:
            def lane_round_accept(carry: ChordsCarry, lanes: LaneState,
                                  i_arr, r, live, prev):
                (new_c, new_l), (emitted, err_sq, out_sq) = lstep(
                    carry, lanes, i_arr, r, prev)
                return (_freeze(new_c, carry, live),
                        _freeze(new_l, lanes, live),
                        emitted & live[:, None], err_sq, out_sq)

            return lane_round_accept

        def lane_round(carry: ChordsCarry, lanes: LaneState, i_arr, r, live):
            (new_c, new_l), emitted = lstep(carry, lanes, i_arr, r)
            return (_freeze(new_c, carry, live), _freeze(new_l, lanes, live),
                    emitted & live[:, None])

        return lane_round

    step = _make_round_step(drift, tgrid, n, k, use_kernel=use_kernel,
                            fuse_accept=fuse_accept)

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


def lane_init_state(num_slots: int, k: int, device="cpu") -> LaneState:
    """Idle [S, K] lane state: zero offsets, unsettled stability, every
    gate off (the grid behaves exactly until an admission opts a slot in
    through :func:`reset_lanes`)."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return LaneState(pos=zeros((num_slots, k), torch.int32),
                     f_norm=zeros((num_slots, k), torch.float32),
                     stab=torch.ones((num_slots, k), dtype=torch.float32,
                                     device=device),
                     skips=zeros((num_slots, k), torch.int32),
                     draft_on=zeros((num_slots,), torch.bool),
                     skip_tau=zeros((num_slots,), torch.float32))


def reset_lanes(lanes: LaneState, mask, draft_on, skip_tau) -> LaneState:
    """Lane-state companion of :func:`reset_slots`: re-arm masked slots with
    the admitted request's gates (``draft_on``: [S] bool, ``skip_tau``: [S]
    f32; rows read only where ``mask``)."""
    m = mask[:, None]
    return LaneState(
        pos=torch.where(m, 0, lanes.pos),
        f_norm=torch.where(m, 0.0, lanes.f_norm),
        stab=torch.where(m, 1.0, lanes.stab),
        skips=torch.where(m, 0, lanes.skips),
        draft_on=torch.where(mask, draft_on, lanes.draft_on),
        skip_tau=torch.where(mask, skip_tau, lanes.skip_tau),
    )


def gather_slots(dst, src, mask, src_idx):
    """Masked-gather lane migration between grids of different slot counts.

    ``dst``/``src`` are (nested) tuples of tensors that all lead with the
    slot axis ([S_dst, ...] / [S_src, ...]); ``mask`` [S_dst] bool selects
    the destination lanes to fill and ``src_idx`` [S_dst] the source lane
    of each (read only where ``mask``). Every migrated lane is a row copy,
    no arithmetic, so a request whose lane migrates gives the same output
    bit for bit; unmasked destination lanes are untouched. Returns a new
    tuple of dst's type.
    """
    if isinstance(dst, tuple):
        return type(dst)(*(gather_slots(d, s, mask, src_idx)
                           for d, s in zip(dst, src)))
    idx = src_idx.to(device=src.device, dtype=torch.int64).clamp(
        0, max(0, src.shape[0] - 1))
    return torch.where(bmask(mask, dst), src.index_select(0, idx), dst)


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
