"""Logical-axis sharding: rule tables, the divisibility-aware spec builder,
and their DTensor layouts — port of ``repro.dist.sharding``.

Models and steps name tensor dims with *logical* axes ("embed", "heads",
"batch", ...; ``repro_torch.utils.pspec``). A rule table maps each logical
axis to a mesh axis (or a tuple of mesh axes, or None for replicated).
:class:`ShardingCtx` turns (logical_axes, shape) into a
:class:`PartitionSpec` with the reference's two guarantees:

* a mesh axis is used at most once per tensor (first dim in rule order wins);
* when a shape is given, a dim is only sharded if its size divides the mesh
  axis size — otherwise the displaced mesh axis falls back to another dim of
  the same tensor via ``FALLBACKS``.

The spec logic is plain Python and runs on any object that has
``axis_names`` and a ``shape`` mapping (a fake mesh of any size), or on a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``, a shape
tuple). On a DeviceMesh, :meth:`ShardingCtx.placements` turns a spec into
DTensor placements, one per mesh dim: ``Shard(d)`` where the spec puts that
mesh axis on dim ``d``, else ``Replicate()``. A dim on two mesh axes
(``batch`` on ``("pod", "data")``) takes ``Shard(d)`` on both; DTensor
splits it with the earlier mesh dim outer, which is JAX's block layout when
the spec lists the axes in mesh order (the rule tables do).

``shard_act`` is the in-model annotation hook: inside a ``use_sharding``
context a DTensor is redistributed to the ctx's layout; outside any context,
and on a plain tensor, it is a strict no-op, so every one-device path (CUDA
graph capture included) runs as before.

``vmap_logical``: the port runs its grids batched, so there is no vmap to
lift; it only registers the lifted logical axis so that interior
``shard_act`` calls reserve its mesh axes, and calls ``fn``.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Rule = Union[str, Tuple[str, ...], None]
Rules = Dict[str, Rule]

# --- rule tables (the reference's, verbatim) ---------------------------------

# Training: FSDP over 'data' on the widest param dim (embed), TP over 'model'
# for heads/ffn/vocab, batch data-parallel across pod x data. Optimizer state
# mirrors the param tree so the same table applies (ZeRO-3).
TRAIN_RULES: Rules = {
    # params
    "vocab": "model",
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "layers": None,
    "mem": "model",
    "state": None,
    "conv": None,
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed_act": None,
    "groups": "data",
    "cores": None,
    "slots": None,
}

# Serving: pure TP for params; requests, CHORDS cores and slots ride 'data'.
SERVE_RULES: Rules = {
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "experts": "model",
    "layers": None,
    "mem": "model",
    "state": None,
    "conv": None,
    "batch": "data",
    "seq": None,
    "kv_seq": None,
    "embed_act": None,
    "groups": "data",
    "cores": "data",
    "slots": "data",
}

# FSDP over the layers-stacked dim instead of embed.
TRAIN_LAYERS_FSDP_RULES: Rules = dict(
    TRAIN_RULES, layers="data", embed=None)

# Deep TP for decode: the model axis goes to the stacked layers dim.
SERVE_DEEP_TP_RULES: Rules = dict(SERVE_RULES, layers="model")

# Where a displaced mesh axis may land, in preference order. Only dims that
# are still unsharded and pass the divisibility check are eligible.
FALLBACKS: Dict[str, Tuple[str, ...]] = {
    "model": ("head_dim", "ffn", "kv_seq"),
    "data": ("kv_seq", "seq", "layers"),
    "pod": (),
}


class PartitionSpec(tuple):
    """Per-dim mesh axes: None (replicated), a mesh-axis name, or a tuple of
    names — the layout of ``jax.sharding.PartitionSpec``, as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _as_tuple(rule: Rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def _normalize(entry: Tuple[str, ...]):
    if not entry:
        return None
    if len(entry) == 1:
        return entry[0]
    return entry


def mesh_axes(mesh) -> Tuple[str, ...]:
    """Axis names of a DeviceMesh (``mesh_dim_names``) or of any object
    exposing ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size}: a DeviceMesh's shape is a tuple, a fake mesh's (and a
    JAX mesh's) a mapping."""
    shape = mesh.shape
    if isinstance(shape, tuple):
        return dict(zip(mesh_axes(mesh), (int(s) for s in shape)))
    return {a: int(s) for a, s in dict(shape).items()}


class ShardingCtx:
    """Binds a mesh to a rule table and builds PartitionSpecs and DTensor
    placements."""

    def __init__(self, mesh, rules: Rules):
        self.mesh = mesh
        self.rules = dict(rules)

    # -- spec construction ----------------------------------------------------

    def pspec(self, axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None,
              reserved: Sequence[str] = ()) -> PartitionSpec:
        """PartitionSpec for a tensor with the given logical axes.

        ``shape`` enables the divisibility fallback; ``reserved`` mesh axes
        are treated as already taken (``shard_act`` under
        ``vmap_logical``)."""
        names = mesh_axes(self.mesh)
        axis_size = mesh_sizes(self.mesh)
        used: set = set(reserved)
        entries = [() for _ in axes]
        displaced = []  # mesh axes whose preferred dim failed divisibility

        for i, name in enumerate(axes):
            want = [a for a in _as_tuple(self.rules.get(name))
                    if a in names and a not in used]
            if not want:
                continue
            ways = math.prod(axis_size[a] for a in want)
            if shape is not None and int(shape[i]) % ways != 0:
                displaced.extend(want)
                continue
            entries[i] = tuple(want)
            used.update(want)

        for mesh_axis in displaced:
            if mesh_axis in used:
                continue
            for target in FALLBACKS.get(mesh_axis, ()):
                hit = False
                for i, name in enumerate(axes):
                    if name != target or entries[i]:
                        continue
                    if shape is not None and \
                            int(shape[i]) % axis_size[mesh_axis] != 0:
                        continue
                    entries[i] = (mesh_axis,)
                    used.add(mesh_axis)
                    hit = True
                    break
                if hit:
                    break

        return PartitionSpec(*[_normalize(e) for e in entries])

    def placements(self, axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   reserved: Sequence[str] = ()) -> tuple:
        """DTensor placements (one per mesh dim) of :meth:`pspec`."""
        return spec_placements(self.pspec(axes, shape, reserved),
                               mesh_axes(self.mesh))

    def shard_spec(self, axes: Sequence[Optional[str]],
                   shape: Sequence[int]
                   ) -> Tuple[Tuple[Tuple[str, ...], ...], Tuple[int, ...]]:
        """(per-dim mesh-axis tuples, per-dim shard counts) for
        checkpointing, from the same pspec ``use_sharding`` applies."""
        p = self.pspec(axes, tuple(shape))
        entries = normalize_spec(p, len(shape))
        return entries, shard_grid(entries, mesh_sizes(self.mesh), shape)


def spec_placements(spec: Sequence, names: Sequence[str]) -> tuple:
    """Placements of a PartitionSpec on a mesh with axes ``names``. A dim on
    several mesh axes must list them in mesh order (DTensor splits a dim
    with the earlier mesh dim outer)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        mesh_dims = [names.index(a) for a in _as_tuple(entry)]
        if mesh_dims != sorted(mesh_dims):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for md in mesh_dims:
            out[md] = Shard(d)
    return tuple(out)


# --- pspec -> shard grid (sharded checkpointing) -----------------------------

def normalize_spec(spec, rank: int) -> Tuple[Tuple[str, ...], ...]:
    """PartitionSpec (or any per-dim sequence) -> per-dim mesh-axis tuples,
    padded with replicated dims up to ``rank``."""
    entries = [_as_tuple(e) for e in spec]
    entries += [()] * (rank - len(entries))
    return tuple(entries[:rank])


def shard_grid(entries: Sequence[Tuple[str, ...]],
               axis_sizes: Dict[str, int],
               shape: Sequence[int]) -> Tuple[int, ...]:
    """Per-dim shard counts for a tensor partitioned as ``entries``; a dim
    the mesh product does not divide is stored unsharded (grid 1)."""
    grid = []
    for e, dim in zip(entries, shape):
        ways = math.prod(axis_sizes.get(a, 1) for a in e)
        grid.append(ways if ways > 0 and int(dim) % ways == 0 else 1)
    return tuple(grid)


def shard_slices(grid: Sequence[int], shape: Sequence[int]):
    """Yield (linear_index, slice_tuple) over the shard grid in C order."""
    blocks = [int(d) // g for d, g in zip(shape, grid)]
    for j, idx in enumerate(itertools.product(*[range(g) for g in grid])):
        yield j, tuple(slice(i * b, (i + 1) * b)
                       for i, b in zip(idx, blocks))


def mesh_desc(mesh) -> Dict[str, Any]:
    """JSON-serializable {axes, shape} of a mesh (what a checkpoint was
    saved under)."""
    axes = list(mesh_axes(mesh))
    sizes = mesh_sizes(mesh)
    return {"axes": axes, "shape": [int(sizes[a]) for a in axes]}


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def tree_shardings(axes_tree: Any, mesh, rules: Rules,
                   struct_tree: Any = None) -> Any:
    """Map a tree of logical-axis tuples to DTensor placements on ``mesh``
    (the counterpart of the reference's NamedShardings); ``struct_tree``
    (a matching tree of tensors) supplies shapes for the divisibility
    fallback."""
    ctx = ShardingCtx(mesh, rules)
    if struct_tree is None:
        return _map_axes(lambda ax: ctx.placements(ax), axes_tree)
    return _map_axes(lambda ax, st: ctx.placements(ax, tuple(st.shape)),
                     axes_tree, struct_tree)


def _map_axes(fn, axes_tree, *rest):
    """``fn`` over the axes tuples of ``axes_tree`` and the matching leaves
    of ``rest`` (dicts or ParamTrees keyed alike)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor laid out on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def distribute_tree(tree: Any, ctx: ShardingCtx, axes: Any) -> Any:
    """Each leaf of ``tree`` (full tensors, the same on every rank of
    ``ctx.mesh``) as a DTensor laid out by its logical axes. Each rank
    keeps its own block; nothing goes on the wire."""
    def one(ax, t):
        if is_dtensor(t):
            return t.redistribute(ctx.mesh,
                                  ctx.placements(ax, tuple(t.shape)))
        return local_dtensor(t, ctx.mesh, ctx.placements(ax, tuple(t.shape)))

    return _map_axes(one, axes, tree)


def block_range(n: int, d: int, mesh, placements) -> Tuple[int, int]:
    """(start, length) of this rank's block of dim ``d`` (``n`` long)
    under ``placements`` on ``mesh`` (Shard dims split with the earlier
    mesh dim outer)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    ways, idx = 1, 0
    for md, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == d:
            idx = idx * sizes[md] + coord[md]
            ways *= sizes[md]
    block = n // ways
    return idx * block, block


def local_block(full, mesh, placements):
    """This rank's block of ``full`` under ``placements`` on ``mesh``."""
    out = full
    for d in range(full.dim()):
        start, length = block_range(full.shape[d], d, mesh, placements)
        if length != full.shape[d]:
            out = out.narrow(d, start, length)
    return out


def local_dtensor(full, mesh, placements):
    """A DTensor from ``full`` (the same on every rank), each rank keeping
    its block: no collective, where ``distribute_tensor`` scatters from a
    source rank. A block that is the whole (contiguous) tensor shares its
    storage."""
    from torch.distributed.tensor import DTensor

    shape = tuple(full.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local_block(full, mesh, placements).contiguous(),
                              mesh, placements, run_check=False,
                              shape=shape, stride=stride)


# --- ambient context ---------------------------------------------------------

_local = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_local, "stack", [None])[-1]


@contextlib.contextmanager
def use_sharding(mesh, rules: Rules):
    """Activate (mesh, rules) so ``shard_act`` lays out activations."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = [None]
    stack.append(ShardingCtx(mesh, rules))
    try:
        yield stack[-1]
    finally:
        stack.pop()


def _vmap_prefix() -> list:
    st = getattr(_local, "vmap_prefix", None)
    if st is None:
        st = _local.vmap_prefix = []
    return st


@contextlib.contextmanager
def vmapped_axes(*logical_names: str):
    """Declare leading logical axes currently lifted by an enclosing
    ``vmap_logical``: ``shard_act`` reserves their mesh axes."""
    st = _vmap_prefix()
    st.extend(logical_names)
    try:
        yield
    finally:
        del st[len(st) - len(logical_names):]


def _reserved_axes(ctx: ShardingCtx) -> Tuple[str, ...]:
    """Mesh axes owned by the active vmap prefix, in prefix order."""
    names = mesh_axes(ctx.mesh)
    out = []
    for name in _vmap_prefix():
        for a in _as_tuple(ctx.rules.get(name)):
            if a in names and a not in out:
                out.append(a)
    return tuple(out)


def vmap_logical(fn, logical_axis: str, in_axes=0, out_axes=0):
    """The reference's vmap over a named logical axis. ``fn`` here is
    already batched over that axis (the port runs grids batched), so the
    call only registers the axis so that interior ``shard_act`` calls
    reserve its mesh axes; ``in_axes``/``out_axes`` are accepted for the
    reference's signature."""
    del in_axes, out_axes

    def call(*args):
        with vmapped_axes(logical_axis):
            return fn(*args)

    return call


def shard_act(x, logical_axes: Sequence[Optional[str]]):
    """Lay out an activation by the ambient rules: inside a
    ``use_sharding`` context a DTensor is redistributed to the ctx's
    placements; outside any context, and on a plain tensor, ``x`` is
    returned as it is.

    Under ``vmap_logical`` the tensor carries the lifted dims in front of
    ``logical_axes``: they take their own rules' mesh axes and the interior
    dims are laid out with those axes reserved."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    prefix = _vmap_prefix()
    lifted = list(prefix[len(prefix) - (x.dim() - len(logical_axes)):]) \
        if x.dim() > len(logical_axes) else []
    spec = list(ctx.pspec(logical_axes, tuple(x.shape)[len(lifted):],
                          reserved=_reserved_axes(ctx)))
    names = mesh_axes(ctx.mesh)
    taken: list = []
    head = []
    for name in lifted:
        want = tuple(a for a in _as_tuple(ctx.rules.get(name))
                     if a in names and a not in taken)
        taken.extend(want)
        head.append(_normalize(want))
    placements = spec_placements(tuple(head) + tuple(spec), names)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(ctx.mesh, placements)
