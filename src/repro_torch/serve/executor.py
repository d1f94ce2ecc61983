"""Round executor: the serve programs behind one keyed cache — port of
``repro.serve.executor``.

A :class:`GridSpec` names a slot grid (S, K, latent shape, dtype) and keys a
bounded LRU cache of its program set — the lockstep ``round``, the masked
``admit`` and ``init_state``; a :class:`StreamSpec` keys the batch
streaming-accept program (``StreamingSampler``'s). PyTorch runs eagerly, so
a "program" is the Python closure built for one spec; ``retraces`` /
``stream_traces`` count cache misses exactly as the reference counts jit
traces (one per distinct spec ever, cache hits thereafter).

``use_kernel=True`` builds the slot round on the fused step + rectify +
accept kernel (``repro_torch.kernels.rectify``): the accept sums leave the
kernel as [S, K] scalars and ``accept_from_sums`` finishes the decision.
On the CPU the kernel's plain version runs and outputs are bitwise those of
``use_kernel=False``; ``kernel_path`` names which implementation served.

Not ported yet: the multi-round device loop and ``roll`` (ROADMAP.md queue
1 item 8), lane migration (item 6), heterogeneous lane grids (item 7).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler
from repro_torch.core.chords import (ChordsCarry, accept_from_sums,
                                     accept_test, bmask, chords_init_carry,
                                     make_round_body, make_slot_round_body,
                                     reset_slots, slot_init_carry)
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.utils.convert import torch_dtype


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Hashable name of one slot grid — the program-cache key."""

    num_slots: int
    num_cores: int
    latent_shape: Tuple[int, ...]
    dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "latent_shape", tuple(self.latent_shape))
        if self.num_slots < 1 or self.num_cores < 1:
            raise ValueError(f"need S >= 1 and K >= 1, got {self}")


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Cache key for the batch streaming-accept program."""

    num_cores: int
    i_seq: Tuple[int, ...]
    rtol: float
    batched: bool = False

    def __post_init__(self):
        object.__setattr__(self, "i_seq", tuple(int(i) for i in self.i_seq))


class SlotState(NamedTuple):
    """Device-side state of the continuous-batching slot grid; every leaf
    leads with the slot axis."""

    carry: ChordsCarry          # [S, K, ...] lockstep grid
    i_arr: torch.Tensor         # [S, K] per-slot init sequence (int32)
    rtol: torch.Tensor          # [S] per-slot accept tolerance (f32)
    rounds: torch.Tensor        # [S] next lockstep round per slot (int32)
    live: torch.Tensor          # [S] slot occupied and still iterating
    done: torch.Tensor          # [S] converged, result buffered for drain
    has_last: torch.Tensor      # [S] a previous streamed output exists
    last_out: torch.Tensor      # [S, ...] latest streamed output per slot
    result: torch.Tensor        # [S, ...] accepted output (valid where done)
    rounds_used: torch.Tensor   # [S] lockstep rounds at accept (int32)
    chosen: torch.Tensor        # [S] accepted core index (int32)


class GridPrograms(NamedTuple):
    """One GridSpec's program set (shared via the executor cache)."""

    spec: GridSpec
    round: Callable       # (SlotState) -> SlotState
    admit: Callable       # (SlotState, mask, x0, i_arr, rtol) -> SlotState
    init_state: Callable  # () -> SlotState


def _grid_fns(drift, tgrid, n: int, spec: GridSpec, use_kernel: bool) -> dict:
    s, k = spec.num_slots, spec.num_cores
    dev = tgrid.device
    dtype = torch_dtype(spec.dtype)
    # use_kernel engages the FUSED round: solver step + rectification +
    # accept reduction in one kernel pass, err/out sums as [S, K] scalars
    fuse_accept = bool(use_kernel)
    slot_round = make_slot_round_body(drift, tgrid, n, k,
                                      use_kernel=use_kernel,
                                      fuse_accept=fuse_accept)
    rows = torch.arange(s, device=dev)

    def round_fn(st: SlotState) -> SlotState:
        """One lockstep round for every live slot + per-slot accept test."""
        active = st.live
        if fuse_accept:
            carry, hit, err_sq, out_sq = slot_round(
                st.carry, st.i_arr, st.rounds, active, st.last_out)
        else:
            carry, hit = slot_round(st.carry, st.i_arr, st.rounds, active)
        emit = scheduler.emit_rounds_t(st.i_arr, n)  # [S, K]
        r = st.rounds
        any_emit = hit.any(dim=1)
        # first True = slowest emitter (torch.argmax takes no bool on CUDA)
        ek = hit.to(torch.uint8).argmax(dim=1)
        out = carry.x[rows, ek]  # [S, ...]
        if fuse_accept:
            # the emitting core's carry.x row IS x_new, so its in-kernel sums
            # are accept_test's sums of `out`; dead-lane garbage is masked
            agree = accept_from_sums(err_sq[rows, ek], out_sq[rows, ek],
                                     st.rtol)
        else:
            agree = accept_test(out, st.last_out, st.rtol, 1)
        ok = any_emit & st.has_last & agree
        # core 0's emission is the exact sequential solve: force-accept it
        final = any_emit & (r >= emit[:, 0])
        acc = (ok | final) & active
        ek32 = ek.to(torch.int32)
        return SlotState(
            carry=carry,
            i_arr=st.i_arr,
            rtol=st.rtol,
            rounds=torch.where(active, r + 1, r),
            live=st.live & ~acc,
            done=st.done | acc,
            has_last=st.has_last | any_emit,
            last_out=torch.where(bmask(any_emit, out), out, st.last_out),
            result=torch.where(bmask(acc, out), out, st.result),
            rounds_used=torch.where(acc, r, st.rounds_used),
            chosen=torch.where(acc, ek32, st.chosen),
        )

    def admit_fn(st: SlotState, mask, x0, i_arr, rtol) -> SlotState:
        """Masked admission: reset lanes + per-slot accept state in place.
        ``x0`` [S, ...] holds the admitted requests' noise (rows read only
        where ``mask``); the engine draws it on the device."""
        carry = reset_slots(st.carry, mask, x0, i_arr)
        m_lat = bmask(mask, st.last_out)
        zero = torch.zeros((), dtype=dtype, device=dev)
        z32 = torch.zeros((), dtype=torch.int32, device=dev)
        return SlotState(
            carry=carry,
            i_arr=torch.where(mask[:, None], i_arr.to(torch.int32), st.i_arr),
            rtol=torch.where(mask, rtol, st.rtol),
            rounds=torch.where(mask, torch.ones_like(st.rounds), st.rounds),
            live=st.live | mask,
            done=st.done & ~mask,
            has_last=st.has_last & ~mask,
            last_out=torch.where(m_lat, zero, st.last_out),
            result=torch.where(m_lat, zero, st.result),
            rounds_used=torch.where(mask, z32, st.rounds_used),
            chosen=torch.where(mask, z32, st.chosen),
        )

    def init_state() -> SlotState:
        lat = torch.zeros((s,) + spec.latent_shape, dtype=dtype, device=dev)

        def zs(dt):
            return torch.zeros((s,), dtype=dt, device=dev)

        return SlotState(
            carry=slot_init_carry(s, k, spec.latent_shape, dtype, dev),
            i_arr=torch.zeros((s, k), dtype=torch.int32, device=dev),
            rtol=zs(torch.float32),
            rounds=torch.ones((s,), dtype=torch.int32, device=dev),
            live=zs(torch.bool), done=zs(torch.bool),
            has_last=zs(torch.bool),
            last_out=lat, result=lat.clone(),
            rounds_used=zs(torch.int32), chosen=zs(torch.int32),
        )

    return {"round": round_fn, "admit": admit_fn, "init_state": init_state}


def _build_grid(drift, tgrid, n: int, spec: GridSpec,
                use_kernel: bool) -> GridPrograms:
    fns = _grid_fns(drift, tgrid, n, spec, use_kernel)
    return GridPrograms(spec=spec, round=fns["round"], admit=fns["admit"],
                        init_state=fns["init_state"])


def _build_stream(drift, tgrid, n: int, spec: StreamSpec,
                  use_kernel: bool) -> Callable:
    """The early-exit streaming program (StreamingSampler's).

    The reference runs it as one ``while_loop`` on the device; here the
    host reads ``accepted.all()`` back once per round to stop early (rounds
    after every request accepted cannot change a result). That per-round
    sync is a cost to remove with the multi-round device loop (ROADMAP.md
    queue 1 item 8).
    """
    dev = tgrid.device
    i_arr = torch.as_tensor(spec.i_seq, dtype=torch.int32, device=dev)
    emit = scheduler.emit_rounds(list(spec.i_seq), n)  # static: host side
    round_body = make_round_body(drift, tgrid, i_arr, n, spec.num_cores,
                                 use_kernel=use_kernel)
    rtol, bdim = spec.rtol, (1 if spec.batched else 0)

    def run(x0, live):
        carry = chords_init_carry(x0, i_arr, spec.num_cores)
        accepted = ~live
        last_out = torch.zeros_like(x0)
        has_last = False
        chosen = torch.zeros(live.shape, dtype=torch.int32, device=dev)
        rounds = torch.zeros(live.shape, dtype=torch.int32, device=dev)
        result = torch.zeros_like(x0)
        for r in range(1, n + 1):
            if bool(accepted.all()):
                break
            carry, _ = round_body(carry, r)
            if not (emit == r).any():
                continue  # no arrival this round: accept state unchanged
            emitted_k = int(np.argmax(emit == r))  # the core emitting now
            out = carry.x[emitted_k]
            if has_last:
                ok = accept_test(out, last_out, rtol, bdim) & ~accepted
                result = torch.where(bmask(ok, out), out, result)
                rounds = torch.where(ok, torch.full_like(rounds, r), rounds)
                chosen = torch.where(ok, torch.full_like(chosen, emitted_k),
                                     chosen)
                accepted = accepted | ok
            last_out = out
            has_last = True
        # requests that never early-exited take the final emission — core
        # 0's full-round output, i.e. the sequential solve
        fell_through = live & (rounds == 0)
        result = torch.where(bmask(fell_through, result), last_out, result)
        rounds = torch.where(fell_through, torch.full_like(rounds, n), rounds)
        return result, rounds, chosen

    return run


class RoundExecutor:
    """Owner of every serve program, behind a keyed LRU cache.

    One executor wraps one ``(drift, tgrid)`` pair and runs on
    ``tgrid.device``. ``retraces`` counts grid-spec cache misses and
    ``stream_traces`` stream-spec ones.
    """

    def __init__(self, drift: Callable, tgrid, n_steps: Optional[int] = None,
                 use_kernel: bool = False, max_entries: int = 8,
                 tracer=None, metrics=None):
        self.drift = drift
        self.tgrid = tgrid
        self.n = int(n_steps) if n_steps is not None \
            else int(tgrid.shape[0]) - 1
        if self.n != int(tgrid.shape[0]) - 1:
            raise ValueError(
                f"n_steps {self.n} != len(tgrid)-1 {int(tgrid.shape[0]) - 1}")
        self.use_kernel = bool(use_kernel)
        self.max_entries = max(1, int(max_entries))
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._grids: "collections.OrderedDict[GridSpec, GridPrograms]" = \
            collections.OrderedDict()
        self._streams: "collections.OrderedDict[StreamSpec, Callable]" = \
            collections.OrderedDict()
        self._c_retraces = self.metrics.counter("executor.retraces")
        self._c_stream_traces = self.metrics.counter(
            "executor.stream_traces")

    @property
    def device(self) -> torch.device:
        return self.tgrid.device

    @staticmethod
    def _lru_get(cache, key, build, max_entries):
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit, False
        val = build()
        cache[key] = val
        while len(cache) > max_entries:
            cache.popitem(last=False)
        return val, True

    def grid(self, spec: GridSpec) -> GridPrograms:
        """Program set for ``spec`` — built once, cache-hit thereafter."""
        progs, missed = self._lru_get(
            self._grids, spec,
            lambda: _build_grid(self.drift, self.tgrid, self.n, spec,
                                self.use_kernel),
            self.max_entries)
        if missed:
            self._c_retraces.inc()
            self.tracer.instant("retrace", kind="grid",
                                spec=f"S={spec.num_slots},"
                                     f"K={spec.num_cores}")
        return progs

    def stream(self, spec: StreamSpec) -> Callable:
        """``(x0, live) -> (result, rounds, chosen)`` early-exit streaming
        program for ``spec``."""
        fn, missed = self._lru_get(
            self._streams, spec,
            lambda: _build_stream(self.drift, self.tgrid, self.n, spec,
                                  self.use_kernel),
            self.max_entries)
        if missed:
            self._c_stream_traces.inc()
            self.tracer.instant("retrace", kind="stream",
                                spec=f"K={spec.num_cores},"
                                     f"batched={spec.batched}")
        return fn

    @property
    def retraces(self) -> int:
        return int(self._c_retraces.value)

    @property
    def stream_traces(self) -> int:
        return int(self._c_stream_traces.value)

    @property
    def kernel_path(self) -> str:
        """Which solver-step implementation serves this executor's rounds:
        ``"fused-accept-cuda"`` (the CUDA kernel), ``"fused-accept-ref"``
        (the fused round with the kernel's plain version, on the CPU) or
        ``"torch-unfused"`` (``use_kernel=False``)."""
        if not self.use_kernel:
            return "torch-unfused"
        return ("fused-accept-cuda" if self.device.type == "cuda"
                else "fused-accept-ref")
