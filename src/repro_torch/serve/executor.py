"""Round executor: the serve programs behind one keyed cache — port of
``repro.serve.executor``.

A :class:`GridSpec` names a slot grid (S, K, latent shape, dtype, an
optional static cap on the multi-round loop, and an optional lane profile)
and keys a bounded LRU cache of its program set — the lockstep ``round``,
the multi-round ``multi`` (exits at the first new accept) and ``roll`` (no
accept exit), the masked ``admit`` and ``init_state``; a
:class:`StreamSpec` keys the batch streaming-accept program
(``StreamingSampler``'s). ``retraces`` / ``stream_traces`` count cache
misses exactly as the reference counts jit traces (one per distinct spec
ever, cache hits thereafter). ``migrate(src_spec, dst_spec)`` is the lane
migration of an elastic resize: ``core.chords.gather_slots`` over a whole
:class:`SlotState`, a bit-exact row copy into the destination grid's state.

Two kinds of program set, named by ``RoundExecutor.programs``:

- ``"graph"`` (the default on CUDA): ``round`` and ``multi`` are one CUDA
  graph launch each over static state buffers (``serve/graphs.py``, the
  counterpart of ``jax.jit``), ``multi``'s exit decided on the device;
  ``roll`` is k launches of the round graph. A capture or instantiation
  error raises.
- ``"eager"`` (the CPU, or ``eager=True``): Python closures over the
  same round body; ``multi``/``roll`` are a Python loop over ``round`` with
  the device loop's condition (``kernels/device_loop``). They are the plain
  version the graphs are held to, and the source of the round's capture.

``use_kernel=True`` builds the slot round on the fused step + rectify +
accept kernel (``repro_torch.kernels.rectify``): the accept sums leave the
kernel as [S, K] scalars and ``accept_from_sums`` finishes the decision.
On the CPU the kernel's plain version runs and outputs are bitwise those of
``use_kernel=False``; ``kernel_path`` names which implementation served.

A ``lane_profile`` in the spec builds the heterogeneous round
(``core.chords`` lanes): the state gains a ``LaneState`` and ``admit`` two
per-slot gates (``draft_on``, ``skip_tau``); the profile is part of the
key, so homogeneous and heterogeneous grids of one shape never alias.

The batch streaming program runs as one device loop too: on the card
``GraphStream``, a WHILE graph whose condition kernel reads ``pending``.

**On a mesh.** Built inside ``use_sharding(mesh, rules)`` (the context is
taken at build time, as ``jax.jit`` takes it at trace time, and its
:func:`ambient_sharding_tag` is part of both specs, so a program built
under a mesh is never served to a bare engine), a grid's state is
DTensors, every leaf led by the slots and laid out by
``ctx.placements(("slots", ...))``; ``round``, ``admit`` and the loops'
rounds run on each rank's block of slots (``vmap_logical`` over
``slots``), and ``multi``'s exit is reduced over the slots' mesh axes by
the device loop's condition (any slot on any rank that accepts stops every
rank). S must be a multiple of the slots' mesh ways. The stream program
lays its cores out the same way (``core.chords.make_round_body``); its
emitting core's latent reaches every rank (``dist.sharding.take_rows``).
On the card a mesh of one rank keeps the graph programs; a wider mesh
needs ``eager=True``, asked for explicitly.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import scheduler
from repro_torch.core.chords import (ChordsCarry, LaneSpec,
                                     accept_from_sums, accept_test, bmask,
                                     chords_init_carry, gather_slots,
                                     lane_init_state, make_round_body,
                                     make_slot_round_body, reset_lanes,
                                     reset_slots, slot_init_carry)
from repro_torch.dist.sharding import (current_ctx, is_dtensor,
                                       local_dtensor, map_tensors, mesh_sizes,
                                       take_rows, use_sharding, vmap_logical,
                                       whole)
from repro_torch.kernels.device_loop.ops import loop_step
from repro_torch.kernels.device_loop.ref import EXIT_ON_ACCEPT, FIRST
from repro_torch.obs import NULL_TRACER, MetricsRegistry
from repro_torch.utils.convert import torch_dtype


def ambient_sharding_tag() -> Optional[str]:
    """Stable tag for the active ``use_sharding`` context (``None`` outside
    one), the reference's string for the same mesh shape and rules.
    Engines put it in their spec keys so programs built under different
    mesh contexts never alias a cache entry."""
    ctx = current_ctx()
    if ctx is None:
        return None
    axes = mesh_sizes(ctx.mesh)
    return f"mesh={sorted(axes.items())};rules={sorted(ctx.rules.items())}"


@contextlib.contextmanager
def _under(ctx):
    """The context a program was built under, again for its call."""
    if ctx is None:
        yield
        return
    with use_sharding(ctx.mesh, ctx.rules):
        yield


def _mesh_ways(ctx, axis: str) -> int:
    """How many ways ``axis`` splits under ``ctx`` (1 off a mesh)."""
    if ctx is None:
        return 1
    sizes = mesh_sizes(ctx.mesh)
    rule = ctx.rules.get(axis)
    names = (rule,) if isinstance(rule, str) else tuple(rule or ())
    return int(np.prod([sizes[a] for a in names if a in sizes] or [1]))


def place(tree, ctx, axis: str):
    """Every tensor of ``tree`` (the same on every rank) as a DTensor led
    by logical ``axis`` (the rest replicated) under ``ctx``; each rank
    keeps its block, nothing goes on the wire. ``tree`` as it is off a
    mesh."""
    if ctx is None:
        return tree

    def one(t):
        return local_dtensor(t, ctx.mesh, ctx.placements(
            (axis,) + (None,) * (t.dim() - 1), tuple(t.shape)))

    return map_tensors(one, tree)


def read_rows(t, rows):
    """``t[rows]`` on every rank, ``rows`` a list of slots: of a
    slot-sharded DTensor only those rows cross ranks (the finished slots'
    results, never the grid)."""
    return take_rows(t, torch.as_tensor(rows, dtype=torch.int64,
                                        device=t.device))


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Hashable name of one slot grid — the program-cache key.

    ``device_rounds`` is an optional static CAP on the multi-round loop:
    ``multi`` never runs more than this many rounds a call, whatever budget
    it is called with. ``None`` (the default, and what the engines pass)
    leaves the budget to the call, so varying R never rebuilds.
    ``lane_profile`` (a tuple of ``core.chords.LaneSpec`` or ``None``)
    selects the heterogeneous round. ``sharding`` is the
    :func:`ambient_sharding_tag` the grid is built under."""

    num_slots: int
    num_cores: int
    latent_shape: Tuple[int, ...]
    dtype: str = "float32"
    device_rounds: Optional[int] = None
    lane_profile: Optional[Tuple[LaneSpec, ...]] = None
    sharding: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "latent_shape", tuple(self.latent_shape))
        if self.lane_profile is not None:
            object.__setattr__(self, "lane_profile",
                               tuple(self.lane_profile))
        if self.num_slots < 1 or self.num_cores < 1:
            raise ValueError(f"need S >= 1 and K >= 1, got {self}")


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Cache key for the batch streaming-accept program (``sharding``:
    the :func:`ambient_sharding_tag` it is built under)."""

    num_cores: int
    i_seq: Tuple[int, ...]
    rtol: float
    batched: bool = False
    sharding: Optional[str] = None

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
    # a LaneState on heterogeneous grids, () on homogeneous ones
    lanes: object = ()


class ProgramRecord(NamedTuple):
    """One enumerable program: a fresh body and example arguments.

    The static analysis (``repro_torch.analysis``) traces
    ``make_fx(fn, tracing_mode="real")(*args)`` of each, on the executor's
    device, without building a grid or touching the cache.
    """

    name: str     # e.g. "grid[S=4,K=4,(8,),float32]/round"
    kind: str     # round | admit | multi | roll | stream | migrate
    fn: Callable
    args: Tuple   # tensors (pytrees) matching the program's signature


class GridPrograms(NamedTuple):
    """One GridSpec's program set (shared via the executor cache).

    The graph programs advance one set of static state buffers in place,
    so a caller that must read or reinstate an earlier state (the overlap
    engine's verify and rollback) takes it with ``keep`` and puts it back
    with ``restore``; the eager programs are functional (they never write
    their inputs), so there ``keep`` and ``restore`` return their
    argument. ``put`` makes a state the grid's own (copied into the graph
    grid's buffers; the state itself on the eager path) and ``reset``
    gives the grid's state at ``init_state``'s values again, for an
    elastic engine that comes back to a bucket it used before."""

    spec: GridSpec
    round: Callable       # (SlotState) -> SlotState
    roll: Callable        # (SlotState, k) -> SlotState: k rounds, no accept exit
    multi: Callable       # (SlotState, max_rounds) -> (SlotState, ran [] int32)
    admit: Callable       # (SlotState, mask, x0, i_arr, rtol[, draft_on,
    #                        skip_tau on a lane grid]) -> SlotState
    init_state: Callable  # () -> SlotState
    keep: Callable        # (SlotState) -> a copy later programs leave alone
    restore: Callable     # (kept SlotState) -> SlotState
    put: Callable         # (SlotState) -> the grid's state holding it
    reset: Callable       # () -> the grid's state at init values
    close: Callable       # () -> None: free the programs' device memory
    graphs: object = None  # serve.graphs.GraphGrid on the graph path


def state_tensors(st: SlotState) -> list:
    """Every tensor of ``st``, in a fixed order."""
    return [*st.carry, *st[1:-1], *st.lanes]


def _grid_fns(drift, tgrid, n: int, spec: GridSpec, use_kernel: bool) -> dict:
    s, k = spec.num_slots, spec.num_cores
    dev = tgrid.device
    dtype = torch_dtype(spec.dtype)
    ctx = current_ctx()
    ways = _mesh_ways(ctx, "slots")
    if s % ways:
        raise ValueError(f"grid {spec}: S={s} is not a multiple of the "
                         f"{ways} ways the mesh splits the slots into")
    # use_kernel engages the FUSED round: solver step + rectification +
    # accept reduction in one kernel pass, err/out sums as [S, K] scalars
    fuse_accept = bool(use_kernel)
    hetero = spec.lane_profile is not None
    slot_round = make_slot_round_body(drift, tgrid, n, k,
                                      use_kernel=use_kernel,
                                      fuse_accept=fuse_accept,
                                      lane_profile=spec.lane_profile)
    rows_all = torch.arange(s, device=dev)

    def round_local(st: SlotState) -> SlotState:
        """One lockstep round for every live slot + per-slot accept test
        (this rank's slots on a mesh)."""
        rows = rows_all[:st.live.shape[0]]
        active = st.live
        lanes = st.lanes
        if hetero and fuse_accept:
            carry, lanes, hit, err_sq, out_sq = slot_round(
                st.carry, st.lanes, st.i_arr, st.rounds, active, st.last_out)
        elif hetero:
            carry, lanes, hit = slot_round(st.carry, st.lanes, st.i_arr,
                                           st.rounds, active)
        elif fuse_accept:
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
            lanes=lanes,
        )

    lifted_round = vmap_logical(round_local, "slots")

    def round_fn(st: SlotState) -> SlotState:
        with _under(ctx):
            return lifted_round(st)

    def admit_local(st: SlotState, mask, x0, i_arr, rtol, draft_on=None,
                    skip_tau=None) -> SlotState:
        if hetero != (draft_on is not None and skip_tau is not None):
            raise ValueError(f"admit on {spec}: the lane gates draft_on and "
                             f"skip_tau go with a lane profile, and only "
                             f"with one")
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
            lanes=(reset_lanes(st.lanes, mask, draft_on, skip_tau)
                   if hetero else ()),
        )

    lifted_admit = vmap_logical(admit_local, "slots")

    def admit_fn(st: SlotState, mask, x0, i_arr, rtol, draft_on=None,
                 skip_tau=None) -> SlotState:
        """Masked admission: reset lanes + per-slot accept state. ``x0``
        [S, ...] holds the admitted requests' noise (rows read only where
        ``mask``); the engine draws it on the device. A lane grid also
        takes the admitted requests' gates (``draft_on`` [S] bool,
        ``skip_tau`` [S] f32; 0 = exact). On a mesh the arguments are
        the whole [S, ...] arrays, the same on every rank; each rank
        admits into its own slots."""
        with _under(ctx):
            return lifted_admit(st, mask, x0, i_arr, rtol, draft_on,
                                skip_tau)

    def init_state() -> SlotState:
        lat = torch.zeros((s,) + spec.latent_shape, dtype=dtype, device=dev)

        def zs(dt):
            return torch.zeros((s,), dtype=dt, device=dev)

        return place(SlotState(
            carry=slot_init_carry(s, k, spec.latent_shape, dtype, dev),
            i_arr=torch.zeros((s, k), dtype=torch.int32, device=dev),
            rtol=zs(torch.float32),
            rounds=torch.ones((s,), dtype=torch.int32, device=dev),
            live=zs(torch.bool), done=zs(torch.bool),
            has_last=zs(torch.bool),
            last_out=lat, result=lat.clone(),
            rounds_used=zs(torch.int32), chosen=zs(torch.int32),
            lanes=lane_init_state(s, k, dev) if hetero else (),
        ), ctx, "slots")

    def loop_body(st: SlotState, done0, ctrl, flags: int):
        """One pass of the device loop's body: the round, then the loop's
        condition on the state it returns (``done0`` and ``ctrl`` updated
        in place; ``ctrl[3]`` the condition). Returns (state, ctrl)."""
        st = round_fn(st)
        loop_step(st.live, st.done, done0, ctrl, flags)
        return st, ctrl

    def _loop(st: SlotState, budget: int, flags: int):
        """Up to ``budget`` rounds, the device loop's condition evaluated on
        entry and after each round; returns (state, rounds run)."""
        ctrl = torch.tensor([int(budget), 0, 0, 0], dtype=torch.int32,
                            device=dev)
        done0 = torch.empty_like(st.done)
        go = loop_step(st.live, st.done, done0, ctrl, flags | FIRST)
        while bool(go):
            st, _ = loop_body(st, done0, ctrl, flags)
        return st, ctrl[1].clone()

    def multi_fn(st: SlotState, max_rounds):
        """Up to ``max_rounds`` rounds (capped by ``spec.device_rounds``),
        leaving as soon as any slot's accept fires: ``done`` rises against
        the flags at entry (drained slots keep their stale flag until
        re-admission, so the difference is exactly "newly finished") or no
        lane is live. Returns (state, rounds run)."""
        if spec.device_rounds is not None:
            max_rounds = min(int(max_rounds), spec.device_rounds)
        return _loop(st, max_rounds, EXIT_ON_ACCEPT)

    def roll_fn(st: SlotState, k) -> SlotState:
        """Exactly ``k`` rounds with no accept exit (the overlap engine's
        fast path, when no lane can finish within them). Rounds on an
        all-dead grid are the identity, so stopping when no lane is live is
        bitwise the k-fold ``round``."""
        return _loop(st, k, 0)[0]

    return {"round": round_fn, "admit": admit_fn, "init_state": init_state,
            "multi": multi_fn, "roll": roll_fn, "loop_body": loop_body}


def _same(st):
    return st


def _graphs_on_mesh(eager: bool) -> None:
    """Graph programs under a mesh context hold only on a mesh of one
    rank: a wider mesh's rounds run collectives and its loop exit is
    reduced across ranks on the host, so the caller asks for the eager
    programs (``eager=True``); nothing falls back on its own."""
    ctx = current_ctx()
    if eager or ctx is None:
        return
    if int(np.prod(list(mesh_sizes(ctx.mesh).values()))) > 1:
        raise ValueError(
            f"CUDA graph programs serve a mesh of one rank; this mesh is "
            f"{mesh_sizes(ctx.mesh)}: build the RoundExecutor with "
            f"eager=True")


def _build_grid(drift, tgrid, n: int, spec: GridSpec, use_kernel: bool,
                eager: bool) -> GridPrograms:
    _graphs_on_mesh(eager)
    fns = _grid_fns(drift, tgrid, n, spec, use_kernel)
    if not eager:
        from repro_torch.serve.graphs import GraphGrid
        return GraphGrid(fns, spec, tgrid.device).programs()
    return GridPrograms(spec=spec, round=fns["round"], roll=fns["roll"],
                        multi=fns["multi"], admit=fns["admit"],
                        init_state=fns["init_state"], keep=_same,
                        restore=_same, put=_same,
                        reset=fns["init_state"], close=lambda: None)


def _migrate_on_mesh(dst, src, mask, src_idx):
    """``gather_slots`` between two slot-sharded grids: only the migrated
    lanes cross ranks (:func:`read_rows` of each source lane, every rank
    receiving them), then each rank writes its own destination slots. The
    host reads the mask and the source lanes first (a migration is rare)."""
    m = whole(mask).cpu().numpy()
    idx = whole(src_idx).cpu().numpy()
    slots = [j for j in range(len(m)) if m[j]]
    lanes = [int(idx[j]) for j in slots]
    pos = torch.as_tensor(slots, dtype=torch.int64, device=mask.device)

    def sel(d, s_):
        if isinstance(d, tuple):
            return type(d)(*(sel(a, b) for a, b in zip(d, s_)))
        full = torch.zeros(d.shape, dtype=d.dtype, device=mask.device)
        if slots:
            full[pos] = read_rows(s_, lanes).to(mask.device)
        return full

    def pick(d, s_, mk):
        if isinstance(d, tuple):
            return type(d)(*(pick(a, b, mk) for a, b in zip(d, s_)))
        return torch.where(bmask(mk, d), s_, d)

    return vmap_logical(pick, "slots")(dst, sel(dst, src), mask)


class StreamState(NamedTuple):
    """The stream program's loop state (the JAX loop's carry, in order),
    every leaf on the device."""

    carry: ChordsCarry          # [K, ...] lockstep grid
    r: torch.Tensor             # [] int32 round counter
    accepted: torch.Tensor      # [B] or [] accepted (padding born accepted)
    last_out: torch.Tensor      # latest streamed output
    has_last: torch.Tensor      # [] bool: a streamed output exists
    chosen: torch.Tensor        # accepted core (int32)
    rounds: torch.Tensor        # round of the accept (int32; 0: none yet)
    result: torch.Tensor        # accepted output
    pending: torch.Tensor       # [max(B, 1)] bool: ~accepted, the loop
    #                             condition's operand (csrc/device_loop.cu)


def emit_core_table(i_seq, n: int) -> np.ndarray:
    """``table[r]`` = the core whose output arrives at round ``r``
    (the first such core, as ``argmax(emit == r)``), -1 where none does;
    rounds 0 .. n + 1."""
    emit = scheduler.emit_rounds(list(i_seq), n)
    table = np.full(n + 2, -1, np.int32)
    for k in range(len(emit) - 1, -1, -1):
        if 0 <= emit[k] <= n + 1:
            table[emit[k]] = k
    return table


def _stream_fns(drift, tgrid, n: int, spec: StreamSpec,
                use_kernel: bool) -> dict:
    """The early-exit streaming program (StreamingSampler's) as the JAX
    loop's pieces: ``init(x0, live)``, one round ``body(state)`` and
    ``finish(state) -> (result, rc)`` with ``rc = [rounds, chosen]``
    stacked (int32, one readback). The round counter, the emitting core
    (a gather from the static :func:`emit_core_table`), ``has_last`` and
    every decision are device tensors: a round takes no host decision."""
    dev = tgrid.device
    k = spec.num_cores
    ctx = current_ctx()
    ways = _mesh_ways(ctx, "cores")
    if k % ways:
        raise ValueError(f"stream {spec}: K={k} is not a multiple of the "
                         f"{ways} ways the mesh splits the cores into")
    i_arr = torch.as_tensor(spec.i_seq, dtype=torch.int32, device=dev)
    emit_core = torch.as_tensor(emit_core_table(spec.i_seq, n), device=dev)
    round_body = make_round_body(drift, tgrid, i_arr, n, k,
                                 use_kernel=use_kernel)
    rtol, bdim = spec.rtol, (1 if spec.batched else 0)

    def init(x0, live) -> StreamState:
        accepted = ~live
        return StreamState(
            carry=place(chords_init_carry(x0, i_arr, k), ctx, "cores"),
            r=torch.ones((), dtype=torch.int32, device=dev),
            accepted=accepted, last_out=torch.zeros_like(x0),
            has_last=torch.zeros((), dtype=torch.bool, device=dev),
            chosen=torch.zeros(live.shape, dtype=torch.int32, device=dev),
            rounds=torch.zeros(live.shape, dtype=torch.int32, device=dev),
            result=torch.zeros_like(x0), pending=live.reshape(-1).clone())

    def body(st: StreamState) -> StreamState:
        carry, _ = round_body(st.carry, st.r)
        core = emit_core.index_select(0, st.r.reshape(1).long())  # [1]
        any_emit = core[0] >= 0
        emitted_k = core.clamp(min=0)
        # on a mesh the emitting core's latent comes from its rank to all
        out = take_rows(carry.x, emitted_k.long())[0]
        ok = any_emit & st.has_last & accept_test(out, st.last_out, rtol,
                                                  bdim) & ~st.accepted
        result = torch.where(bmask(ok, out), out, st.result)
        rounds = torch.where(ok, st.r, st.rounds)
        chosen = torch.where(ok, emitted_k[0], st.chosen)
        accepted = st.accepted | ok
        last_out = torch.where(any_emit, out, st.last_out)
        return StreamState(carry, st.r + 1, accepted, last_out,
                           st.has_last | any_emit, chosen, rounds, result,
                           ~accepted.reshape(-1))

    def finish(st: StreamState, live):
        # requests that never early-exited take the final emission — core
        # 0's full-round output, i.e. the sequential solve
        fell_through = live & (st.rounds == 0)
        result = torch.where(bmask(fell_through, st.result), st.last_out,
                             st.result)
        rounds = torch.where(fell_through,
                             torch.full_like(st.rounds, n), st.rounds)
        return result, torch.stack([rounds, st.chosen])

    def under(fn):
        def call(*args):
            with _under(ctx):
                return fn(*args)
        return call

    if ctx is None:
        return {"init": init, "body": body, "finish": finish}
    return {"init": under(init), "body": under(body),
            "finish": under(finish)}


class EagerStream:
    """The stream program run eagerly: the plain version on the CUDA card
    (``RoundExecutor(eager=True)``), and the program on the CPU. The loop's
    exit is the JAX loop's ``~all(accepted) & r <= n``, evaluated by the
    device loop's condition (``kernels/device_loop``) on ``pending`` with
    budget N; the host reads it once a round (``readbacks`` counts those
    reads on a CUDA card, where each is a device round trip)."""

    def __init__(self, fns: dict, n: int, device):
        self._fns = fns
        self.n = n
        self.device = torch.device(device)
        self.readbacks = 0
        self.rounds_run = 0

    def __call__(self, x0, live):
        st = self._fns["init"](x0, live)
        s = st.pending.shape[0]
        ctrl = torch.tensor([self.n, 0, 0, 0], dtype=torch.int32,
                            device=self.device)
        done = torch.zeros(s, dtype=torch.bool, device=self.device)
        done0 = torch.zeros_like(done)
        go = loop_step(st.pending, done, done0, ctrl, FIRST)
        cuda = self.device.type == "cuda"
        while bool(go):
            self.readbacks += cuda
            st = stream_loop_body(self._fns, st, done, done0, ctrl)
            self.rounds_run += 1
        self.readbacks += cuda
        return self._fns["finish"](st, live)


def stream_loop_body(fns: dict, st: StreamState, done, done0, ctrl):
    """One pass of the stream loop's body: the round, then the loop's
    condition on ``pending`` (``ctrl[3]``; ``done`` and ``done0`` stay
    zero: the stream exits on its own accepts, budget N)."""
    st = fns["body"](st)
    loop_step(st.pending, done, done0, ctrl, 0)
    return st


def _build_stream(drift, tgrid, n: int, spec: StreamSpec, use_kernel: bool,
                  eager: bool, batch_shape=None) -> Callable:
    """The stream program for ``spec``: eager, or on CUDA one graph for the
    batch shape of ``x0`` (``serve/graphs.py::GraphStream``), built at its
    first call."""
    _graphs_on_mesh(eager)
    fns = _stream_fns(drift, tgrid, n, spec, use_kernel)
    if eager:
        return EagerStream(fns, n, tgrid.device)
    from repro_torch.serve.graphs import GraphStream
    return GraphStream(fns, n, tgrid.device)


def _loop_program(loop_body, flags: int):
    """A grid's device loop as its loop program runs it: the entry
    condition, then one pass of the WHILE body (round and condition).
    Returns (state, ctrl)."""
    def program(st: SlotState, done0, ctrl):
        loop_step(st.live, st.done, done0, ctrl, flags | FIRST)
        return loop_body(st, done0, ctrl, flags)
    return program


def _stream_program(fns: dict, n: int):
    """The stream program as its loop program runs it: init, the entry
    condition, one pass of the WHILE body, finish. Returns ((result, rc),
    the loop state: what the next pass would read)."""
    def program(x0, live):
        st = fns["init"](x0, live)
        s = st.pending.shape[0]
        ctrl = torch.tensor([n, 0, 0, 0], dtype=torch.int32,
                            device=x0.device)
        done = torch.zeros(s, dtype=torch.bool, device=x0.device)
        done0 = torch.zeros_like(done)
        loop_step(st.pending, done, done0, ctrl, FIRST)
        st = stream_loop_body(fns, st, done, done0, ctrl)
        return fns["finish"](st, live), st
    return program


class RoundExecutor:
    """Owner of every serve program, behind a keyed LRU cache.

    One executor wraps one ``(drift, tgrid)`` pair and runs on
    ``tgrid.device``. ``retraces`` counts grid-spec cache misses and
    ``stream_traces`` stream-spec ones. The grid programs are CUDA graphs
    on CUDA and eager closures on the CPU; ``eager=True`` takes the eager
    closures on CUDA too (the plain version the graphs are held to). A
    graph grid owns one set of state buffers, so it serves one engine: give
    each engine its own executor. An evicted graph grid frees its memory
    and refuses further calls; a grid an engine has pinned (its capacity
    ladder) is never evicted.
    """

    def __init__(self, drift: Callable, tgrid, n_steps: Optional[int] = None,
                 use_kernel: bool = False, max_entries: int = 8,
                 tracer=None, metrics=None, eager: bool = False):
        self.drift = drift
        self.tgrid = tgrid
        self.n = int(n_steps) if n_steps is not None \
            else int(tgrid.shape[0]) - 1
        if self.n != int(tgrid.shape[0]) - 1:
            raise ValueError(
                f"n_steps {self.n} != len(tgrid)-1 {int(tgrid.shape[0]) - 1}")
        self.use_kernel = bool(use_kernel)
        self.eager = bool(eager) or tgrid.device.type != "cuda"
        self.max_entries = max(1, int(max_entries))
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._grids: "collections.OrderedDict[GridSpec, GridPrograms]" = \
            collections.OrderedDict()
        self._streams: "collections.OrderedDict[StreamSpec, Callable]" = \
            collections.OrderedDict()
        self._pinned: set = set()      # specs no eviction may take
        self._migrations: set = set()  # (src S, dst S, profile) pairs
        self._ctx: dict = {}  # spec -> the sharding context it was built in
        self._c_retraces = self.metrics.counter("executor.retraces")
        self._c_stream_traces = self.metrics.counter(
            "executor.stream_traces")

    @property
    def device(self) -> torch.device:
        return self.tgrid.device

    def _lru_get(self, cache, key, build):
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit, False
        unpinned = [k for k in cache if k not in self._pinned]
        if len(cache) >= self.max_entries and not unpinned:
            raise RuntimeError(
                f"the executor's cache holds {len(cache)} pinned grids "
                f"(max_entries={self.max_entries}): reserve_grid_capacity "
                f"before asking for another")
        val = build()
        cache[key] = val
        while len(cache) > self.max_entries:  # least recently used first
            evicted = cache.pop(unpinned.pop(0))
            close = getattr(evicted, "close", None)  # graphs free memory
            if close is not None:
                close()
        return val, True

    def reserve_grid_capacity(self, n: int) -> None:
        """Make room for ``n`` more grid specs without evicting resident
        ones. Engines call this with their bucket-ladder size, so a ladder
        never evicts (or rebuilds) its own grids."""
        self.max_entries = max(self.max_entries, len(self._grids) + int(n))

    def pin(self, spec: GridSpec) -> GridPrograms:
        """``grid(spec)``, kept in the cache from now on: an elastic
        engine pins its whole ladder, so no eviction can take a grid that
        holds live lanes or the source of a migration."""
        progs = self.grid(spec)
        self._pinned.add(spec)
        return progs

    def grid(self, spec: GridSpec) -> GridPrograms:
        """Program set for ``spec`` — built once, cache-hit thereafter."""
        progs, missed = self._lru_get(
            self._grids, spec,
            lambda: _build_grid(self.drift, self.tgrid, self.n, spec,
                                self.use_kernel, self.eager))
        if missed:
            self._ctx[spec] = current_ctx()
            self._c_retraces.inc()
            self.tracer.instant("retrace", kind="grid",
                                spec=f"S={spec.num_slots},"
                                     f"K={spec.num_cores}")
        return progs

    def stream(self, spec: StreamSpec) -> Callable:
        """``(x0, live) -> (result, rc)`` early-exit streaming program for
        ``spec``, ``rc = [rounds, chosen]`` (int32): an :class:`EagerStream`,
        or on CUDA a ``GraphStream`` (one graph launch a call)."""
        fn, missed = self._lru_get(
            self._streams, spec,
            lambda: _build_stream(self.drift, self.tgrid, self.n, spec,
                                  self.use_kernel, self.eager))
        if missed:
            self._c_stream_traces.inc()
            self.tracer.instant("retrace", kind="stream",
                                spec=f"K={spec.num_cores},"
                                     f"batched={spec.batched}")
        return fn

    def migrate(self, src_spec: GridSpec, dst_spec: GridSpec) -> Callable:
        """The lane-migration program ``(dst_state, src_state, mask,
        src_idx) -> SlotState`` between two grids that differ only in S:
        ``core.chords.gather_slots`` (every migrated lane a bit-exact row
        copy) written into the destination grid's state (on the graph path
        its static buffers, which its graphs read). It runs on the current
        stream, after whatever is in flight on the source grid."""
        if src_spec.num_cores != dst_spec.num_cores \
                or src_spec.latent_shape != dst_spec.latent_shape \
                or src_spec.dtype != dst_spec.dtype \
                or src_spec.lane_profile != dst_spec.lane_profile:
            raise ValueError(
                f"can only migrate lanes between grids differing in S: "
                f"{src_spec} -> {dst_spec}")
        put = self.grid(dst_spec).put
        self._migrations.add((src_spec.num_slots, dst_spec.num_slots,
                              src_spec.lane_profile))

        ctx = self._ctx.get(dst_spec)

        def run(dst, src, mask, src_idx):
            if is_dtensor(dst.live):
                with _under(ctx):
                    return put(_migrate_on_mesh(dst, src, mask, src_idx))
            return put(gather_slots(dst, src, mask, src_idx))

        return run

    # -- static-analysis enumeration hook -------------------------------------

    def enumerate_programs(self, grid_specs=(), stream_specs=(),
                           stream_latent_shape=(4,), stream_batch: int = 2,
                           migrate_pairs=()) -> list:
        """Every program this executor can build for the given specs, as
        :class:`ProgramRecord`s with the reference's names, each a fresh
        body with example arguments on the executor's device.

        A grid gives ``round``, ``admit`` and the two device loops:
        ``multi`` and ``roll`` are each the loop program a CUDA graph runs
        (the entry condition, then the WHILE body: one round and the
        condition kernel), not the host loop the CPU drives it with. A
        stream spec gives its program the same way (init, entry, one body
        pass, finish); a migrate pair ``gather_slots`` between the two
        grids' states. Records are built fresh: enumeration never builds
        a cached grid nor counts in ``retraces``.
        """
        dev = self.device
        records: list = []
        for spec in grid_specs:
            fns = _grid_fns(self.drift, self.tgrid, self.n, spec,
                            self.use_kernel)
            st = fns["init_state"]()
            s, k = spec.num_slots, spec.num_cores
            lane_tag = ""
            admit_extra: tuple = ()
            if spec.lane_profile is not None:
                roles = "".join("D" if sp.role == "draft" else
                                ("A" if sp.skip else "R")
                                for sp in spec.lane_profile)
                lane_tag = f",lanes={roles}"
                admit_extra = (torch.ones(s, dtype=torch.bool, device=dev),
                               torch.zeros(s, dtype=torch.float32,
                                           device=dev))
            dtype = torch_dtype(spec.dtype)
            tag = (f"grid[S={s},K={k},{spec.latent_shape},"
                   f"{str(dtype).removeprefix('torch.')}{lane_tag}]")
            records.append(ProgramRecord(
                f"{tag}/round", "round", fns["round"], (st,)))
            records.append(ProgramRecord(
                f"{tag}/admit", "admit", fns["admit"],
                (st, torch.ones(s, dtype=torch.bool, device=dev),
                 torch.zeros((s,) + spec.latent_shape, dtype=dtype,
                             device=dev),
                 torch.zeros((s, k), dtype=torch.int32, device=dev),
                 torch.zeros(s, dtype=torch.float32, device=dev))
                + admit_extra))
            for kind, flags in (("multi", EXIT_ON_ACCEPT), ("roll", 0)):
                records.append(ProgramRecord(
                    f"{tag}/{kind}", kind,
                    _loop_program(fns["loop_body"], flags),
                    (st, torch.empty_like(st.done), torch.tensor(
                        [8, 0, 0, 0], dtype=torch.int32, device=dev))))
        for spec in stream_specs:
            fns = _stream_fns(self.drift, self.tgrid, self.n, spec,
                              self.use_kernel)
            shape = ((stream_batch,) + tuple(stream_latent_shape)
                     if spec.batched else tuple(stream_latent_shape))
            live = torch.ones((stream_batch,) if spec.batched else (),
                              dtype=torch.bool, device=dev)
            records.append(ProgramRecord(
                f"stream[K={spec.num_cores},i={list(spec.i_seq)},"
                f"rtol={spec.rtol},batched={spec.batched}]", "stream",
                _stream_program(fns, self.n),
                (torch.zeros(shape, dtype=torch.float32, device=dev), live)))
        for src, dst in migrate_pairs:
            s_src, s_dst = src.num_slots, dst.num_slots
            init = {sp: _grid_fns(self.drift, self.tgrid, self.n, sp,
                                  self.use_kernel)["init_state"]()
                    for sp in (src, dst)}
            records.append(ProgramRecord(
                f"migrate[{s_src}->{s_dst}]", "migrate", gather_slots,
                (init[dst], init[src],
                 torch.ones(s_dst, dtype=torch.bool, device=dev),
                 torch.zeros(s_dst, dtype=torch.int32, device=dev))))
        return records

    @property
    def migration_traces(self) -> int:
        """Distinct (source S, destination S) migrations set up, the count
        the reference takes from its jitted gather's cache."""
        return len(self._migrations)

    @property
    def retraces(self) -> int:
        return int(self._c_retraces.value)

    @property
    def stream_traces(self) -> int:
        return int(self._c_stream_traces.value)

    @property
    def programs(self) -> str:
        """``"graph"`` (each grid program one CUDA graph launch) or
        ``"eager"``."""
        return "eager" if self.eager else "graph"

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
