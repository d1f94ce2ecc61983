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
lift. It registers the lifted logical axis so that interior ``shard_act``
calls reserve its mesh axes, and where that axis rides a mesh axis of the
ambient context and the arguments are DTensors, it runs ``fn`` on each
rank's block of the axis (:func:`on_blocks`): a vmap over a sharded axis
is independent per block, which is what the JAX package's
``spmd_axis_name`` vmap compiles to. Inside such a region the tensors are
plain local blocks, so ops that DTensor has no strategy for (``roll``,
broadcast masks, indexing by a tensor) run as on one device;
:func:`lift_rows` puts the rows of a call that must be tensor-parallel
(the drift) back on the mesh, and :func:`roll_blocks` is the roll over a
blocked axis, the boundary element moved to the next rank.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

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


def whole(t):
    """A DTensor's full value (a collective: every rank of its mesh calls
    it); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


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


def reduce_blocks(t, mesh, dims: Sequence[int], op: str = "sum"):
    """``t``, this rank's partial result (a plain tensor), reduced with
    ``op`` (``"sum"``, ``"max"``) over the mesh dims ``dims``: DTensor's
    own all-reduce of a ``Partial`` (which ``collectives.CollectiveLog``
    counts), the other mesh dims left as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    part = [Partial(op) if md in dims else Replicate()
            for md in range(mesh.ndim)]
    return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


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
    already batched over that axis (the port runs grids batched): the call
    registers the axis so that interior ``shard_act`` calls reserve its
    mesh axes and, on DTensor arguments whose axis rides the mesh, runs
    ``fn`` on each rank's block of it (:func:`on_blocks`; ``in_axes`` 0 or
    None per argument, as there). ``out_axes`` is accepted for the
    reference's signature: outputs lead with the lifted axis."""
    del out_axes

    def call(*args):
        with vmapped_axes(logical_axis):
            return on_blocks(fn, logical_axis, in_axes)(*args)

    return call


# --- per-rank blocks of a lifted axis ----------------------------------------

class Block(NamedTuple):
    """One active :func:`on_blocks` region: the rows of ``axis`` that this
    rank runs, the ``index``-th of ``ways`` equal blocks along the mesh
    axes ``mesh_axes`` (``placements``: Shard(0) on those mesh dims,
    Replicate on the others)."""

    mesh: Any
    axis: str
    mesh_axes: Tuple[str, ...]
    placements: tuple
    index: int
    ways: int


def _block_stack() -> list:
    st = getattr(_local, "blocks", None)
    if st is None:
        st = _local.blocks = []
    return st


def current_block(axis: Optional[str] = None) -> Optional[Block]:
    """The innermost active block region (of logical ``axis`` if given)."""
    for b in reversed(_block_stack()):
        if axis is None or b.axis == axis:
            return b
    return None


def block_offset(axis: str, n_local: int) -> int:
    """The global index of this rank's first row of ``axis`` (0 outside a
    block region of it); ``n_local`` is the block's length."""
    b = current_block(axis)
    return 0 if b is None else b.index * n_local


def map_tensors(fn, tree):
    """``fn`` over the tensor leaves of tuples (NamedTuples kept), lists
    and dicts (a state tree); other leaves as they are."""
    import torch

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        kids = [map_tensors(fn, t) for t in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    if isinstance(tree, list):
        return [map_tensors(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


def _any_dtensor(tree) -> bool:
    found = []
    map_tensors(lambda t: found.append(is_dtensor(t)) or t, tree)
    return any(found)


def _block_of(ctx: ShardingCtx, logical_axis: str) -> Optional[Block]:
    """The block region ``logical_axis`` would open under ``ctx``: None
    where it rides no free mesh axis (none in its rule, or every one taken
    by an enclosing lifted axis or block region)."""
    names = mesh_axes(ctx.mesh)
    prefix = list(_vmap_prefix())
    if prefix and prefix[-1] == logical_axis:
        prefix = prefix[:-1]  # vmap_logical registers the axis it opens
    taken = {a for name in prefix for a in _as_tuple(ctx.rules.get(name))}
    for b in _block_stack():
        taken.update(b.mesh_axes)
    want = tuple(a for a in _as_tuple(ctx.rules.get(logical_axis))
                 if a in names and a not in taken)
    return _block(ctx.mesh, logical_axis, want) if want else None


def _block(mesh, axis: str, on: Tuple[str, ...]) -> Block:
    """The block of ``axis`` split over mesh axes ``on`` (outer first)
    that this rank holds."""
    names = mesh_axes(mesh)
    coord = mesh.get_coordinate()
    sizes = mesh_sizes(mesh)
    index, ways = 0, 1
    for a in on:
        index = index * sizes[a] + coord[names.index(a)]
        ways *= sizes[a]
    return Block(mesh, axis, tuple(on), spec_placements((tuple(on),), names),
                 index, ways)


def on_blocks(fn, logical_axis: str, in_axes=0):
    """``fn`` run on this rank's block of ``logical_axis`` (dim 0 of every
    argument with ``in_axes`` 0), the counterpart of a ``shard_map`` over
    the mesh axes the ambient rules give that axis.

    Applies only inside a ``use_sharding`` context on a DeviceMesh, with
    some argument a DTensor and the axis on a free mesh axis; otherwise
    ``fn(*args)``. A DTensor argument is laid out Shard(0) on the axis'
    mesh dims and Replicate on the others (a redistribute where it was
    not) and handed to ``fn`` as its local block; a plain tensor argument
    (the same on every rank) as its block. Tensor outputs come back as
    DTensors in that layout, 0-d ones as plain tensors (a value every rank
    computed alike). Inside, :func:`lift_rows` and :func:`roll_blocks`
    see the region."""
    def call(*args):
        ctx = current_ctx()
        if ctx is None or not hasattr(ctx.mesh, "get_coordinate") \
                or not _any_dtensor(args):
            return fn(*args)
        blk = _block_of(ctx, logical_axis)
        if blk is None:
            return fn(*args)
        axes = in_axes if isinstance(in_axes, (tuple, list)) \
            else (in_axes,) * len(args)

        def local(t):
            if t.dim() == 0:
                return whole(t)
            if t.shape[0] % blk.ways:
                raise ValueError(
                    f"{logical_axis} of length {t.shape[0]} does not split "
                    f"into the {blk.ways} blocks of mesh axes "
                    f"{blk.mesh_axes}")
            if is_dtensor(t):
                if tuple(t.placements) != blk.placements:
                    t = t.redistribute(blk.mesh, blk.placements)
                return t.to_local()
            return local_block(t, blk.mesh, blk.placements)

        largs = [map_tensors(local if ax == 0 else whole, a)
                 for a, ax in zip(args, axes)]
        st = _block_stack()
        st.append(blk)
        try:
            out = fn(*largs)
        finally:
            st.pop()
        return map_tensors(
            lambda t: t if t.dim() == 0 else to_blocks(t, blk), out)

    return call


def to_blocks(t, blk: Block):
    """The local block ``t`` as a DTensor laid out as ``blk``."""
    from torch.distributed.tensor import DTensor

    shape = (t.shape[0] * blk.ways,) + tuple(t.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(t, blk.mesh, blk.placements, run_check=False,
                              shape=shape, stride=stride)


def _row_blocks() -> Optional[Block]:
    """The active block regions as one layout of flattened rows: their
    mesh axes on dim 0, outer region first (rows are slot-major)."""
    st = _block_stack()
    if not st:
        return None
    axes: list = []
    for b in st:
        axes.extend(a for a in b.mesh_axes if a not in axes)
    return _block(st[-1].mesh, st[-1].axis, tuple(axes))


def lift_rows(fn):
    """Inside a block region, ``fn`` (a row function: every tensor
    argument's dim 0 is rows, the block's rows flattened with whatever
    follows them) runs with its rows back on the mesh: each tensor
    argument a DTensor Shard(0) on the region's mesh axes, so that
    ``fn``'s parameters may be tensor-parallel over the others; the
    output comes back as this rank's local rows. ``shard_act`` inside
    keeps the region's mesh axes on dim 0 and plain constants are taken
    as replicated (``implicit_replication``). Outside a region,
    ``fn(*args)``."""
    def call(*args):
        blk = _row_blocks()
        if blk is None:
            return fn(*args)
        from torch.distributed.tensor.experimental import \
            implicit_replication

        lifted = [to_blocks(a, blk) if hasattr(a, "dim") and a.dim() > 0
                  else a for a in args]
        saved = _block_stack()[:]
        st = getattr(_local, "row_axes", None)
        _local.row_axes = blk.mesh_axes
        _block_stack().clear()  # fn runs on the whole mesh again
        try:
            with implicit_replication():
                out = fn(*lifted)
        finally:
            _block_stack().extend(saved)
            _local.row_axes = st

        def back(t):
            if not is_dtensor(t):
                return t
            if tuple(t.placements) != blk.placements:
                t = t.redistribute(blk.mesh, blk.placements)
            return t.to_local()

        return map_tensors(back, out)

    return call


def rows_layout(x) -> tuple:
    """DTensor ``x``'s placements with only its dim-0 (rows) splits kept."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)


def whole_for_rows(t, rows):
    """``whole(t)`` for a computation on this rank's rows under the row
    layout ``rows``: its gradient comes back as a partial sum over the mesh
    dims that split the rows (each rank's rows add their share), where
    ``full_tensor``'s default takes it as every rank's whole gradient."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate, Shard

    return t.full_tensor(grad_placements=[
        Partial() if isinstance(r, Shard) else Replicate() for r in rows])


def mine(t, mesh, placements):
    """This rank's block of ``t`` laid out as ``placements`` on ``mesh``: a
    DTensor redistributed so where it is not, a plain tensor cut to its
    block; None stays None."""
    if t is None:
        return None
    if not is_dtensor(t):
        return local_block(t, mesh, placements)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t.to_local()


def on_rows(fn, x, *args):
    """``fn(local x, *local args)`` on this rank's rows of DTensor ``x``:
    every tensor in ``args`` (trees; dim 0 rows) as this rank's rows and
    whole in its other dims (:func:`mine`), ``fn``'s tensor outputs back as
    DTensors laid out as the rows. What ``fn`` needs whole besides
    (parameters) it gathers itself (:func:`whole_for_rows`)."""
    from torch.distributed.tensor import DTensor

    mesh, rows = x.device_mesh, rows_layout(x)
    out = fn(mine(x, mesh, rows),
             *(map_tensors(lambda t: mine(t, mesh, rows), a) for a in args))
    return map_tensors(lambda t: DTensor.from_local(t, mesh, rows,
                                                    run_check=False), out)


def split_last(x, shape):
    """``x.reshape(shape)``, where ``shape`` splits ``x``'s last dim in two.
    A DTensor whose last dim is split over mesh dims that the new leading
    dim (heads) does not divide is made whole on them first: DTensor
    cannot unflatten such a split, where XLA re-lays it out."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = x.dim() - 1
        sizes = tuple(x.device_mesh.shape)
        ways = math.prod(s for p, s in zip(x.placements, sizes)
                         if isinstance(p, Shard) and p.dim == last)
        if shape[-2] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last
                else p for p in x.placements])
    return x.reshape(shape)


def _stride_order(stride, dims):
    return tuple(sorted(dims, key=lambda d: (-int(stride[d]), d)))


def _strides_disagree(t) -> bool:
    """Whether DTensor ``t``'s local block orders its dims (those longer
    than 1 there) otherwise than ``t``'s global strides do. DTensor takes a
    view's legality from the global strides and runs it on the block, so
    such a block fails a view that the global tensor allows: an op's local
    result takes its strides from the block's shapes (a dim of length 1,
    an einsum's own path), the DTensor's from the global op's."""
    loc = t.to_local()
    dims = [d for d in range(t.dim()) if loc.shape[d] > 1]
    return _stride_order(loc.stride(), dims) != \
        _stride_order(t.stride(), dims)


def _conformed(t):
    """``t``, or where its block's strides disagree a copy contiguous in
    both views (``contiguous()`` would return a DTensor whose global view
    is contiguous as it is, block and all)."""
    import torch

    if is_dtensor(t) and _strides_disagree(t):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _as_forward(g, placements):
    """Gradient ``g`` laid out as its tensor's forward ``placements`` (a
    partial sum made whole). DTensor's backward may split the gradient
    otherwise (a sequence split over ``model``, or in strides), and then
    cannot follow the view that the forward took (a sequence into chunks
    that the ranks do not divide)."""
    from torch.distributed.tensor import Partial, Replicate

    if not is_dtensor(g):
        return g
    want = tuple(Replicate() if isinstance(p, Partial) else p
                 for p in placements)
    return g if tuple(g.placements) == want else \
        g.redistribute(g.device_mesh, want)


class _Conform:
    """The autograd function of :func:`conform`, built at first use."""

    fn = None

    @classmethod
    def get(cls):
        if cls.fn is None:
            import torch

            class Conform(torch.autograd.Function):
                @staticmethod
                def forward(ctx, t):
                    ctx.placements = t.placements
                    out = _conformed(t)
                    return t.view_as(t) if out is t else out

                @staticmethod
                def backward(ctx, g):
                    return _conformed(_as_forward(g, ctx.placements))

            cls.fn = Conform
        return cls.fn


def _on_wide_mesh(t) -> bool:
    return is_dtensor(t) and math.prod(t.device_mesh.shape) > 1


def conform(t):
    """``t`` as it is, except a DTensor on a mesh of more than one rank
    whose local block's strides disagree with its global ones: that one
    as a copy contiguous in both views. Under autograd its gradient is
    laid out as ``t`` and its block conformed alike. A (1, 1) mesh's block
    is the global tensor, so its path keeps the one-device layout bit for
    bit."""
    if not _on_wide_mesh(t):
        return t
    if t.requires_grad:
        return _Conform.get().apply(t)
    return _conformed(t)


def mesh_einsum(eq: str, *operands):
    """``torch.einsum`` with its operands and result through
    :func:`conform`: on plain tensors and on a (1, 1) mesh exactly
    ``torch.einsum``."""
    import torch

    if not any(_on_wide_mesh(o) for o in operands):
        return torch.einsum(eq, *operands)
    return conform(torch.einsum(eq, *(conform(o) for o in operands)))


def zeros_tree(specs: dict, axes: dict, device,
               skip: Sequence[str] = ()) -> dict:
    """Zeros of a dict of ``(shape, dtype)`` specs (a cache), under the
    ambient context each leaf a DTensor laid out by its logical ``axes``
    of which every rank allocates only its own block: a KV cache held
    whole by every rank before the layout would not fit one
    (qwen1.5-0.5b's at 32 x 32768 is 103 GB). The keys in ``skip`` (a
    cache's ``len``) are plain tensors on the host; outside a context
    every other leaf is a plain tensor on ``device``."""
    import torch

    ctx = current_ctx()
    on_mesh = ctx is not None and hasattr(ctx.mesh, "get_coordinate")
    out = {}
    for k, (shape, dt) in specs.items():
        if k in skip:
            out[k] = torch.zeros(shape, dtype=dt)
        elif not on_mesh:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
        else:
            from torch.distributed.tensor import zeros as dt_zeros

            out[k] = dt_zeros(tuple(shape), dtype=dt, device_mesh=ctx.mesh,
                              placements=ctx.placements(axes[k],
                                                        tuple(shape)))
    return out


def assign(dst, index, src) -> None:
    """``dst[index] = src`` in place. On a DTensor ``dst`` each rank writes
    its own block: ``src`` is laid out as ``dst`` (a redistribute that
    only cuts blocks where ``src`` was whole) and copied into the local
    block. ``index`` may cut a split dim: with a slice (a cache's sequence
    split over ranks) ``src`` is whole along it and each rank writes the
    part of the slice that falls in its block, if any; with a leading
    integer (a layer of a cache whose layers are split) only the ranks
    whose block holds it write. DTensor's own ``index_put`` has no
    strategy on some releases."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not is_dtensor(dst):
        dst[index] = src
        return
    mesh = dst.device_mesh
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.to(dst.dtype)
    want = tuple(dst.placements)
    lead = index if isinstance(index, tuple) else (index,)
    drop = 0  # leading integer indices (a cache's layer) drop their dims
    while drop < len(lead) and isinstance(lead[drop], int):
        drop += 1
    local_index, cuts, mine = list(lead), [], True
    for d in range(drop):  # a split dim's index: its owners write
        if any(isinstance(p, Shard) and p.dim == d for p in want):
            b0, n = block_range(dst.shape[d], d, mesh, dst.placements)
            mine = mine and b0 <= lead[d] % dst.shape[d] < b0 + n
            local_index[d] = lead[d] % dst.shape[d] - b0
    if drop:
        want = tuple((Shard(p.dim - drop) if p.dim >= drop else Replicate())
                     if isinstance(p, Shard) else p for p in want)
    for d in range(drop, len(lead)):
        if not isinstance(lead[d], slice) or lead[d] == slice(None):
            continue
        split = [md for md, p in enumerate(dst.placements)
                 if isinstance(p, Shard) and p.dim == d
                 and mesh.shape[md] > 1]
        if not split:
            continue
        lo, hi, step = lead[d].indices(dst.shape[d])
        if step != 1:
            raise ValueError("assign: a strided slice of a split dim")
        b0, n = block_range(dst.shape[d], d, mesh, dst.placements)
        a = max(lo, b0)  # the slice's part in this block: [a, z)
        z = max(min(hi, b0 + n), a)
        local_index[d] = slice(a - b0, z - b0)
        cuts.append((d - drop, a - lo if z > a else 0, z - a))
        want = tuple(Replicate() if md in split else p
                     for md, p in enumerate(want))
    if tuple(src.placements) != want:
        src = src.redistribute(mesh, want)
    part = src.to_local()
    for d, at, length in cuts:
        part = part.narrow(d, at, length)
    if mine:
        dst.to_local()[tuple(local_index)] = part


def take_rows(x, idx):
    """``x.index_select(0, idx)`` as a plain tensor on every rank. On a
    DTensor whose dim 0 is split over one mesh dim, each rank selects its
    candidates for the rows (clamped into its block), all-gathers them
    over that dim's group and keeps each row's owner's copy, on the
    device: ``len(idx)`` rows a rank on the wire, never ``x``."""
    import torch
    from torch.distributed.tensor import Shard

    if not is_dtensor(x):
        return x.index_select(0, idx)
    loc = x.to_local()
    dims = [md for md, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == 0]
    if not dims:
        return loc.index_select(0, idx)
    if len(dims) > 1:
        raise NotImplementedError("rows split over more than one mesh dim")
    mesh, md = x.device_mesh, dims[0]
    n = loc.shape[0]
    ways = int(mesh.shape[md])
    start = int(mesh.get_coordinate()[md]) * n
    cand = loc.index_select(0, (idx - start).clamp(0, n - 1))
    if ways == 1:
        return cand
    from repro_torch.dist.collectives import all_gather

    got = all_gather(cand, mesh.get_group(md))  # [W, len(idx), ...]
    owner = torch.div(idx, n, rounding_mode="floor")
    return got[owner, torch.arange(idx.shape[0], device=idx.device)]


def roll_blocks(x, shift: int, dim: int, axis: str):
    """``torch.roll(x, shift, dims=dim)`` where ``dim`` of ``x`` is the
    logical ``axis``: inside a block region of that axis the roll crosses
    ranks, so the ``|shift|`` elements that leave the block go to the
    neighbouring rank's block over a ring (one boundary slab a rank, never
    the whole axis); elsewhere the local roll."""
    import torch

    blk = current_block(axis)
    out = torch.roll(x, shift, dims=dim)
    if blk is None or blk.ways == 1:
        return out
    from repro_torch.dist.collectives import ring_shift

    if len(blk.mesh_axes) != 1:
        raise NotImplementedError(
            f"roll over {axis} on mesh axes {blk.mesh_axes}: one mesh axis "
            f"only")
    n = abs(int(shift))
    if n > x.shape[dim]:
        raise NotImplementedError("a roll past a whole block")
    if shift > 0:   # the last n elements go to the next rank's front
        slab = x.narrow(dim, x.shape[dim] - n, n)
        got = ring_shift(slab, +1, blk.mesh.get_group(blk.mesh_axes[0]))
        return torch.cat([got, out.narrow(dim, n, x.shape[dim] - n)], dim)
    slab = x.narrow(dim, 0, n)  # the first n go to the previous rank's end
    got = ring_shift(slab, -1, blk.mesh.get_group(blk.mesh_axes[0]))
    return torch.cat([out.narrow(dim, 0, x.shape[dim] - n), got], dim)


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
    rows = getattr(_local, "row_axes", None) or ()
    reserved = tuple(_reserved_axes(ctx)) + tuple(
        a for a in rows if a not in _reserved_axes(ctx))
    spec = list(ctx.pspec(logical_axes, tuple(x.shape)[len(lifted):],
                          reserved=reserved))
    if rows and not lifted and spec:
        # under lift_rows dim 0 is the lifted axes' rows flattened with
        # the batch: those mesh axes stay on it, outermost
        spec[0] = _normalize(tuple(rows) + _as_tuple(spec[0]))
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
