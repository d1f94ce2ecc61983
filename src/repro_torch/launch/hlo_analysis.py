"""Traced-program analysis: collective census, per-rank FLOPs and bytes,
a cell's local shapes, roofline terms — port of
``repro.launch.hlo_analysis``.

There is no HLO. The port's dry run (``launch/dryrun.py``) runs a cell's
step eagerly on fake tensors over a fake process group, as rank 0 of the
mesh, and :class:`TraceCounter`, a dispatch mode, reads the program as it
runs. DTensor ops are let through to DTensor, which turns each into the
ops on this rank's local shards and the collectives between ranks; the
mode counts only those local ops, so every number is per rank, as the
reference's shapes in SPMD-partitioned HLO are per device:

* **collectives**, by (op, mesh axis, dtype). The port moves data by two
  routes and the census sums both: DTensor's functional collectives
  (what ``dist.collectives.CollectiveLog`` records) and the collectives
  the port hands to ``torch.distributed`` itself (``ring_shift``, the
  compressed step's int8 all-to-all and all-gather), which
  ``dist.collectives.WIRE_GROUPS`` counts. Bytes follow the reference's
  convention (``_MULT``): an all-gather counts its gathered result, a
  reduce-scatter its scattered result, an all-reduce twice its size.
* **FLOPs** of the matmul-like ops on local shards
  (``torch.utils.flop_counter``'s formulas). ``FlopCounterMode`` on
  DTensors counts the global product instead.
* **bytes**: every op's input and output bytes summed: an eager, unfused
  upper bound on a rank's HBM traffic. It is not XLA's fused estimate
  and is not compared with it.
* **live bytes**: the peak of the bytes held by live storages during the
  run (the arguments' included): an eager peak, not XLA's temp size.
* **ops**: the count of local ops run (the counterpart of the HLO's
  size).
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.collectives import NOT_COLLECTIVES, group_axes

# The reference's HLO op names, and its wire multiplier per op.
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}

# op-name prefixes of both routes -> the reference's op name
_OPS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
        ("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
        ("all_to_all", "all-to-all"), ("permute", "collective-permute"),
        ("broadcast", "collective-permute"))

_FUNCTIONAL = ("_c10d_functional", "c10d_functional")


def _ref_op(name: str) -> str:
    for prefix, ref in _OPS:
        if name.startswith(prefix):
            return ref
    raise KeyError(f"hlo_analysis: no census name for collective {name!r}")


def _tensors(tree) -> List[torch.Tensor]:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class TraceCounter(TorchDispatchMode):
    """Counts the local ops of a traced run (see the module docstring).

    ``with TraceCounter(mesh) as tc:`` inside a fake mode, around a step
    on fake DTensors; then ``tc.flops``, ``tc.bytes``, ``tc.ops``,
    ``tc.peak_live_bytes`` and ``tc.collectives`` (DTensor's functional
    collectives, {(op, axis, dtype): [launches, bytes]}). DTensor's
    sharding propagation runs each new op once on global-shaped fake
    tensors to learn its output's shape; those runs are not counted (the
    mode holds the propagator's ``_fake_mode_lock`` hook while active, and
    ops under it pass through). An op whose tensors are all real host
    tensors (the caches' ``len``,
    which a decode step reads on the host) runs on them, outside the fake
    mode. ``track(tree)`` adds pre-existing tensors (the arguments) to the
    live bytes."""

    def __init__(self, mesh):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self._dtensor = DTensor
        self._fake = FakeTensor
        self._flop_registry = flop_registry
        self.axes = group_axes(mesh)
        self.flops = 0.0
        self.flops_by_op: Dict[str, float] = {}
        self.bytes = 0.0
        self.ops = 0
        self.collectives: Dict[Tuple[str, str, str], list] = {}
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: Dict[int, int] = {}
        self._propagating = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        if not hasattr(ShardingPropagator, "_fake_mode_lock"):
            raise RuntimeError(
                "hlo_analysis: this torch's DTensor has no "
                "ShardingPropagator._fake_mode_lock; its shape propagation "
                "could not be told apart from the local ops")
        self._saved_lock = ShardingPropagator._fake_mode_lock
        ShardingPropagator._fake_mode_lock = _Propagating(self)
        self._propagating = 0
        # A strided shard's local size and offsets are index math on a
        # small arange that DTensor reads back with .tolist(), which a
        # fake tensor refuses: it runs on real host tensors here.
        self._saved_strided = _StridedShard.__dict__[
            "local_shard_size_and_offset"]
        _StridedShard.local_shard_size_and_offset = _on_host(
            self._saved_strided)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard

        ShardingPropagator._fake_mode_lock = self._saved_lock
        _StridedShard.local_shard_size_and_offset = self._saved_strided
        return super().__exit__(*exc)

    # -- live storages --------------------------------------------------------

    def _freed(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        if isinstance(t, self._dtensor):
            t = t.to_local()
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key)

    def track(self, tree) -> None:
        for t in _tensors(tree):
            self._hold(t)

    # -- dispatch -------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if self._propagating:  # DTensor learning an output's shape
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented  # let DTensor desugar into local ops
        ins = _tensors((args, kwargs))
        fakes = [t for t in ins if isinstance(t, self._fake)]
        if ins and not fakes:  # host tensors only: run them for real
            return _on_host(func)(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__.rstrip("_")
        if func.namespace in _FUNCTIONAL:
            if name not in NOT_COLLECTIVES:
                self._collective(name, args, kwargs, out)
            return out
        self.ops += 1
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if func.is_view or name in ("detach", "alias", "lift_fresh"):
            return out
        self.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        formula = self._flop_registry.get(func._overloadpacket)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            self.flops += f
            key = func._overloadpacket.__name__
            self.flops_by_op[key] = self.flops_by_op.get(key, 0.0) + f
        return out

    def _collective(self, name, args, kwargs, out):
        group = args[-1] if isinstance(args[-1], str) else \
            kwargs.get("group_name")
        ts = _tensors(out)
        key = (_ref_op(name), self.axes.get(group, "?"), _dtype(ts[0]))
        rec = self.collectives.setdefault(key, [0, 0])
        rec[0] += 1
        rec[1] += sum(_nbytes(t) for t in ts)


def _on_host(fn):
    """``fn`` run with every dispatch mode off (fake tensors included)."""
    from torch.utils._python_dispatch import _disable_current_modes

    def call(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    return call


class _Propagating:
    """Stands in for ``ShardingPropagator._fake_mode_lock`` (a context
    manager DTensor holds around its shape propagation): marks the
    counter's ops under it as propagation."""

    def __init__(self, counter):
        self.counter = counter

    def __enter__(self):
        self.counter._propagating += 1

    def __exit__(self, *exc):
        self.counter._propagating -= 1
        return False


def wire_census(wire_groups: Dict[Tuple[str, str, str], list],
                axes: Dict[str, str]) -> Dict[Tuple[str, str, str], list]:
    """``dist.collectives.WIRE_GROUPS`` ({(op, group, dtype): [launches,
    bytes sent, group size]}) as census entries {(op, axis, dtype):
    [launches, bytes]}: an all-gather counts its gathered result (the bytes
    sent times the group's size), as the reference counts it."""
    out: Dict[Tuple[str, str, str], list] = {}
    for (op, group, dt), (n, sent, size) in wire_groups.items():
        ref = _ref_op(op)
        b = sent * size if ref == "all-gather" else sent
        rec = out.setdefault((ref, axes.get(group, "?"), dt), [0, 0])
        rec[0] += n
        rec[1] += b
    return out


def collective_bytes(*censuses) -> dict:
    """Per-rank collective wire bytes by op (+ ``total``, ``num_ops``),
    summed over the census entries of both routes, each op's bytes times
    the reference's ``_MULT`` (all-reduce twice); ``by_axis`` lists every
    (op, axis, dtype) entry with its launches and bytes."""
    out: Dict[str, float] = {k: 0.0 for k in _MULT}
    merged: Dict[Tuple[str, str, str], list] = {}
    for census in censuses:
        for key, (n, b) in census.items():
            rec = merged.setdefault(key, [0, 0])
            rec[0] += n
            rec[1] += b
    count = 0
    for (op, _, _), (n, b) in merged.items():
        out[op] += b * _MULT[op]
        count += n
    out["total"] = sum(out[k] for k in _MULT)
    out["num_ops"] = count
    out["by_axis"] = [
        {"op": op, "axis": ax, "dtype": dt, "launches": n,
         "bytes": b * _MULT[op]}
        for (op, ax, dt), (n, b) in sorted(merged.items())]
    return out


# --- a cell's local shapes (the ENTRY parameters of the reference) -----------

def _leaves_with_paths(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(
                v, path + (names[i] if names else str(i),))


def local_shape(t: torch.Tensor) -> List[int]:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return [int(d) for d in t.shape]


def entry_param_shapes(tree) -> List[Tuple[str, str, List[int]]]:
    """This rank's (local) shapes of a cell's inputs or outputs:
    [(path, dtype, local dims)] in tree order. A DTensor gives its local
    shard's shape, so comparing it with the global shape says whether the
    input really was partitioned the intended way (e.g. the slot axis
    divided by the 'data' mesh size)."""
    return [(name, _dtype(t), local_shape(t))
            for name, t in _leaves_with_paths(tree)]


def find_param_shape(tree, global_dims) -> List[Tuple[str, List[int]]]:
    """Leaves whose rank matches ``global_dims``: [(path, local dims)].
    The caller checks the local dims are the global dims divided by the
    expected mesh factors."""
    rank = len(global_dims)
    return [(n, dims) for n, _, dims in entry_param_shapes(tree)
            if len(dims) == rank]


def replicated_entry_params(tree, global_shapes, min_bytes: int = 0):
    """Leaves that are FULLY replicated: their local dims equal some global
    shape in ``global_shapes`` exactly, and their size is at least
    ``min_bytes``. Returns [(path, dims, nbytes)]: a large input every rank
    holds whole (the accidental-replication smell)."""
    globals_ = {tuple(int(d) for d in g) for g in global_shapes}
    out = []
    for name, t in _leaves_with_paths(tree):
        dims = local_shape(t)
        if tuple(dims) not in globals_:
            continue
        nbytes = math.prod(dims) * t.element_size()
        if nbytes >= min_bytes:
            out.append((name, dims, nbytes))
    return out


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    return sum(math.prod(local_shape(t)) * t.element_size()
               for _, t in _leaves_with_paths(tree))


# --- roofline ------------------------------------------------------------------

# NVIDIA H100 80GB HBM3 (SXM5) data sheet, at its 700 W power limit: dense
# bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4 bandwidth one way
# between two cards of one 8-card host. A mesh axis wider than one host
# (the (16, 16) pod's axes are 16 cards) crosses the network between
# hosts, whose bandwidth is the cluster's, not a card figure: t_collective
# is then a lower bound.
CARD = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s a card
HBM_BW = 3.35e12  # B/s a card
NVLINK_BW = 450e9  # B/s one way a card, within one host


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float,
                   per_device_min_bytes: float) -> dict:
    """Roofline terms in seconds at the card's figures (per-rank
    quantities: global / (ranks * peak) == per_rank / peak).

    The inputs are not bounds of one kind. The FLOPs are the traced
    program's count, so ``t_compute_s`` is a lower bound on its compute
    time. ``per_device_bytes`` is the eager, unfused upper bound on the
    HBM traffic (``t_memory_s``) and ``per_device_min_bytes`` a lower
    bound (each argument read once, each output written once:
    ``t_memory_min_s``); the traffic of a fused program lies between.
    ``t_collective_s`` is at NVLink's rate, a lower bound wherever an axis
    crosses hosts. So:

    * ``bound_s``: the largest of the three lower bounds (compute, least
      memory, collective), a lower bound on the step's time, and
      ``bottleneck`` the term that sets it;
    * ``bottleneck_eager``: the largest term with the eager bytes in the
      memory term's place.

    Where the two names differ, the step's bottleneck is one of them and
    this analysis cannot say which: a real run's fused bytes and the
    network's rate decide it."""
    t_compute = per_device_flops / PEAK_FLOPS
    t_memory = per_device_bytes / HBM_BW
    t_memory_min = per_device_min_bytes / HBM_BW
    t_coll = per_device_coll_bytes / NVLINK_BW

    def largest(t_mem):
        return max(("compute", t_compute), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])

    dom = largest(t_memory_min)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_memory_min_s": t_memory_min,
        "t_collective_s": t_coll,
        "bottleneck": dom[0],
        "bound_s": dom[1],
        "bottleneck_eager": largest(t_memory)[0],
        "card": CARD,
    }


def spec_local_shape(shape: Sequence[int], placements,
                     sizes: Sequence[int]) -> List[int]:
    """The local shape of a ``shape`` tensor under ``placements`` on a
    mesh of ``sizes`` (each Shard dim divides evenly: the spec builder
    shards only dims that divide)."""
    from torch.distributed.tensor import Shard

    out = [int(d) for d in shape]
    for p, s in zip(placements, sizes):
        if isinstance(p, Shard):
            out[p.dim] //= int(s)
    return out
