"""CUDA graphs of a slot grid's programs — the counterpart of ``jax.jit``
over a grid program (``repro.serve.executor._build_grid``).

On CUDA every state-advancing program of one :class:`GridSpec` is one graph
launch over one set of static state buffers:

- ``round``: the eager round (``executor._grid_fns``) captured once; the
  graph reads the buffers and copies the next state back into them.
- ``multi``: one graph built around the captured round by
  ``csrc/device_loop.cu``: an entry kernel, then a conditional WHILE node
  whose body is the round followed by the device loop's condition kernel.
  The budget R is one device word written before each launch, so one
  graph serves every R, and the device decides when the loop exits: a call
  costs one host readback however many rounds it ran.
- ``roll``: k launches of the round graph. It reads nothing back, and
  rounds on an all-dead grid are the identity, so this is bitwise the
  eager ``roll`` (which stops when no lane is live) with no conditional
  node.
- ``admit`` runs eagerly (a few launches) and writes the admitted lanes
  into the buffers, bitwise what the functional admission returns; on a
  lane grid it also takes the admitted requests' gates, which the captured
  round reads from the buffers (no host decision inside a round).
- ``put`` / ``reset``: an elastic engine's migration gathers lanes from
  another grid's buffers and ``put`` copies the result into this grid's
  (its graphs read fixed addresses); ``reset`` writes ``init_state``'s
  values back when the engine returns to this grid. Both run eagerly on the
  current stream, after whatever is in flight there.
- ``keep`` / ``restore``: the rollback anchor. A graph overwrites the
  buffers in place, so the overlap engine copies the state into a second
  set on the device before a speculative step and copies it back on a
  rollback (about 0.55 MB at the launcher defaults: microseconds).

The round is warmed up on a side stream before capture (kernels set their
shared-memory attributes on their first launch), and captured on the
current device; every kernel wrapper reads the current stream at each
launch, which puts its launches in the capture; Python's automatic garbage
collection is off while it captures (:func:`no_gc`). A capture or
instantiation error raises: there is no eager fallback. Loop programs need a CUDA 12.4
runtime and driver.

The batch stream program (``StreamingSampler``, ``ChordsEngine``) is
:class:`GraphStream`: one graph for a batch shape, the JAX loop
``_build_stream_fn`` on the device: a captured ``init`` from static input
buffers, the device loop's entry kernel, a WHILE node whose body is the
captured round and the condition kernel (exit ``~all(accepted) & r <= N``:
the condition on ``pending = ~accepted`` with budget N), then the captured
fall-through and outputs. A call is two input copies, one graph launch and
the caller's one readback, however many rounds it ran.

Under a mesh context (``use_sharding``) the same programs are captured over
a mesh of one rank, their state DTensors whose local blocks are the static
buffers: DTensor runs no collective there (``executor._graphs_on_mesh``
refuses graphs on a wider mesh).

A replay launches the captured kernels without calling their wrappers; the
kernels count their own launches on the device (``kernels.launch_counts``),
so the counts cover replays with nothing added on the host.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels.device_loop import kernel as loop_kernel
from repro_torch.serve.executor import (GridPrograms, GridSpec, SlotState,
                                        StreamState, state_tensors)

WARMUP_ROUNDS = 2


@contextlib.contextmanager
def no_gc():
    """Python's automatic garbage collection off for the block (a capture):
    a collection inside a capture may finalize an unreachable graph
    program, and destroying a CUDA graph is a call that a capture does not
    permit, so it invalidates the capture (the smoke saw an elastic
    bucket's capture fail so, four ``CUDAGraph.reset`` warnings first).
    ``torch.cuda.graph`` collects once as it opens, before the capture."""
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def _local(t):
    """A DTensor's local block (a plain tensor as it is)."""
    return t.to_local() if is_dtensor(t) else t


def copy_state(dst: SlotState, src: SlotState) -> SlotState:
    """Copy every tensor of ``src`` into ``dst`` (device copies on the
    current stream); returns ``dst``."""
    for d, s in zip(state_tensors(dst), state_tensors(src)):
        if d is not s:
            d.copy_(s)
    return dst


class GraphGrid:
    """The graph program set of one grid: static state buffers, the
    captured round and the ``multi`` loop program around it."""

    def __init__(self, fns: Dict[str, object], spec: GridSpec, device):
        self.spec = spec
        self.device = torch.device(device)
        self._fns = fns
        self._claimed = False
        self._closed = False
        self._loop = None  # the multi program's handle
        t0 = time.perf_counter()
        with torch.no_grad(), torch.cuda.device(self.device):
            self.state = fns["init_state"]()
            self.anchor = fns["init_state"]()
            s = spec.num_slots
            # ctrl: budget, rounds run by this launch, loop rounds run in
            # total, last condition (csrc/device_loop.cu)
            self.ctrl = torch.zeros(4, dtype=torch.int32, device=self.device)
            self.done0 = torch.zeros(s, dtype=torch.bool, device=self.device)
            self._warm_up()
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            with no_gc(), torch.cuda.graph(self.graph):
                copy_state(self.state, fns["round"](self.state))
            self.graph.instantiate()
            # on a mesh of one rank the flags' local blocks are the flags
            self._loop = loop_kernel.graph_create(
                self.graph.raw_cuda_graph(), _local(self.state.live),
                _local(self.state.done), self.done0, self.ctrl)
            torch.cuda.synchronize(self.device)
        self.build_s = time.perf_counter() - t0

    def _warm_up(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ROUNDS):
                self._fns["round"](self.state)  # functional: state unchanged
        torch.cuda.current_stream(self.device).wait_stream(side)

    # -- the programs ---------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError(f"grid {self.spec} was evicted from its "
                               f"executor's cache; its graphs are freed")

    def _check(self, st: SlotState) -> None:
        self._check_open()
        if st is not self.state:
            raise ValueError("a graph grid's programs advance its own state "
                             "buffers: pass the state init_state returned")

    def round(self, st: SlotState) -> SlotState:
        self._check(st)
        self.graph.replay()
        return self.state

    def multi(self, st: SlotState, max_rounds):
        self._check(st)
        if self.spec.device_rounds is not None:
            max_rounds = min(int(max_rounds), self.spec.device_rounds)
        self.ctrl[0].fill_(int(max_rounds))  # a fill kernel: no round trip
        loop_kernel.graph_launch(self._loop, self.device.index or 0)
        return self.state, self.ctrl[1]

    def roll(self, st: SlotState, k) -> SlotState:
        self._check(st)
        for _ in range(int(k)):
            self.graph.replay()
        return self.state

    def admit(self, st: SlotState, mask, x0, i_arr, rtol,
              *gates) -> SlotState:
        self._check(st)
        return copy_state(self.state, self._fns["admit"](st, mask, x0, i_arr,
                                                         rtol, *gates))

    def put(self, st: SlotState) -> SlotState:
        self._check_open()
        return copy_state(self.state, st)

    def reset(self) -> SlotState:
        if not self._claimed:
            raise RuntimeError("reset a grid's state after init_state "
                               "claimed it")
        return self.put(self._fns["init_state"]())

    def init_state(self) -> SlotState:
        if self._claimed:
            raise RuntimeError(
                "this grid's CUDA graphs already serve an engine (they own "
                "one set of state buffers): give each engine its own "
                "RoundExecutor")
        self._claimed = True
        return self.state

    def keep(self, st: SlotState) -> SlotState:
        self._check(st)
        return copy_state(self.anchor, st)

    def restore(self, kept: SlotState) -> SlotState:
        if kept is not self.anchor:
            raise ValueError("restore takes the state keep returned")
        return copy_state(self.state, kept)

    def close(self) -> None:
        """Free the loop program and the captured round's memory pool."""
        if self._closed:
            return
        self._closed = True
        self._destroy_loop()
        self.graph.reset()

    def _destroy_loop(self) -> None:
        loop, self._loop = self._loop, None
        if loop is not None:
            loop_kernel.graph_destroy(loop)

    def __del__(self):
        try:
            self._destroy_loop()
        except Exception:  # noqa: BLE001 - a finalizer must not raise
            pass

    def programs(self) -> GridPrograms:
        return GridPrograms(spec=self.spec, round=self.round,
                            roll=self.roll, multi=self.multi,
                            admit=self.admit, init_state=self.init_state,
                            keep=self.keep, restore=self.restore,
                            put=self.put, reset=self.reset,
                            close=self.close, graphs=self)


def _stream_tensors(st: StreamState) -> list:
    return list(st.carry) + list(st[1:])


def _copy_stream(dst: StreamState, src: StreamState) -> StreamState:
    for d, s in zip(_stream_tensors(dst), _stream_tensors(src)):
        if d is not s:
            d.copy_(s)
    return dst


class _StreamGraph:
    """One batch shape's stream program: static buffers and the loop
    graph around the captured init, round and finish."""

    def __init__(self, fns, n: int, device, x0, live):
        self.device = device
        self._graphs = []
        self._loop = None
        with torch.no_grad(), torch.cuda.device(device):
            self.x0 = x0.clone()
            self.live = live.clone()
            self.state = fns["init"](self.x0, self.live)
            s = self.state.pending.shape[0]
            self.ctrl = torch.tensor([n, 0, 0, 0], dtype=torch.int32,
                                     device=device)
            self.done = torch.zeros(s, dtype=torch.bool, device=device)
            self.done0 = torch.zeros_like(self.done)
            res, rc = fns["finish"](self.state, self.live)
            self.result, self.rc = torch.empty_like(res), torch.empty_like(rc)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):  # first launches set attributes
                for _ in range(WARMUP_ROUNDS):
                    fns["body"](fns["init"](self.x0, self.live))
            torch.cuda.current_stream(device).wait_stream(side)

            def init():
                _copy_stream(self.state, fns["init"](self.x0, self.live))

            def body():
                _copy_stream(self.state, fns["body"](self.state))

            def finish():
                res, rc = fns["finish"](self.state, self.live)
                self.result.copy_(res)
                self.rc.copy_(rc)

            raw = []
            for fn in (init, body, finish):
                g = torch.cuda.CUDAGraph(keep_graph=True)
                with no_gc(), torch.cuda.graph(g):
                    fn()
                g.instantiate()
                self._graphs.append(g)
                raw.append(g.raw_cuda_graph())
            self._loop = loop_kernel.graph_create(
                raw[1], self.state.pending, self.done, self.done0, self.ctrl,
                pre_graph=raw[0], post_graph=raw[2])
            torch.cuda.synchronize(device)

    def __call__(self, x0, live):
        self.x0.copy_(x0)
        self.live.copy_(live)
        loop_kernel.graph_launch(self._loop, self.device.index or 0)
        return self.result.clone(), self.rc.clone()

    def close(self) -> None:
        """Free the loop program and the captured graphs' memory pools."""
        self._destroy_loop()
        for g in self._graphs:
            g.reset()
        self._graphs = []

    def _destroy_loop(self) -> None:
        loop, self._loop = self._loop, None
        if loop is not None:
            loop_kernel.graph_destroy(loop)

    def __del__(self):
        try:
            self._destroy_loop()
        except Exception:  # noqa: BLE001 - a finalizer must not raise
            pass


class GraphStream:
    """The stream program of one ``StreamSpec`` on CUDA: a
    :class:`_StreamGraph` for each batch shape it is called with (built at
    the first call with that shape: capture + instantiation, ``build_s``).
    ``ChordsEngine`` pads every batch to ``max_batch``, so it holds one.
    The outputs are copied out of the graph's buffers, so a later call
    does not overwrite what an earlier one returned. ``readbacks`` is 0:
    the program reads nothing back (the caller's readback is its own)."""

    readbacks = 0

    def __init__(self, fns, n: int, device):
        self._fns = fns
        self.n = n
        self.device = torch.device(device)
        self._shapes: Dict[tuple, _StreamGraph] = {}
        self.build_s = 0.0

    def __call__(self, x0, live):
        key = (tuple(x0.shape), x0.dtype, tuple(live.shape))
        g = self._shapes.get(key)
        if g is None:
            t0 = time.perf_counter()
            g = self._shapes[key] = _StreamGraph(self._fns, self.n,
                                                 self.device, x0, live)
            self.build_s += time.perf_counter() - t0
        return g(x0, live)

    @property
    def rounds_run(self) -> int:
        """Rounds every loop of this program ran so far (the condition
        kernel's count on the device; waits for it)."""
        return sum(int(g.ctrl[2]) for g in self._shapes.values())

    def close(self) -> None:
        for g in self._shapes.values():
            g.close()
        self._shapes.clear()
