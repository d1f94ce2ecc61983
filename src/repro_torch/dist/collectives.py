"""Compressed cross-rank collectives — port of ``repro.dist.collectives``.

``make_compressed_psum(mesh, axis)`` builds an error-feedback int8
all-reduce over one mesh axis: each rank quantizes its (input + carried
residual) to int8 with one f32 scale, the int8 levels and the scales are
all-gathered (that is the wire traffic: 1 byte an element and one f32 scale
a rank, against 2 x 4 bytes an element for a ring all-reduce), and every
rank dequantizes and sums locally. The residual is returned for the caller
to feed back into the next round.

Every collective of this module and of the compressed train step goes
through :func:`all_gather`, :func:`all_to_all` or :func:`all_reduce_max`,
which add the bytes they hand to the wire to :data:`WIRE_GROUPS`, keyed
by (op, process-group name, dtype) with the group's size, so that a census
can say which mesh axis carried them. It is the port's counterpart of
the reference's check for ``s8[...] all-gather|all-to-all`` in the compiled
HLO: ``wire_bytes()`` after a step says what went out, by dtype.

DTensor moves data through functional collectives of its own (a Partial
made whole, an FSDP gather, a re-layout). :class:`CollectiveLog` records
those while it is active, by op and by the mesh axis whose group carried
them, so that a check can say over which axis a reduction ran.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.sharding import is_dtensor

# (op, process-group name, dtype name) -> [launches, bytes this rank
# handed to the wire, group size]
WIRE_GROUPS: Dict[Tuple[str, str, str], list] = {}

# ops of the functional-collective namespaces that move nothing: the wait
# on a collective's result, and the wrap of that result for autograd
NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def reset_wire_bytes() -> None:
    WIRE_GROUPS.clear()


def wire_bytes() -> Dict[Tuple[str, str], int]:
    """{(op, dtype): bytes sent by this rank}, over every group."""
    out: Dict[Tuple[str, str], int] = {}
    for (op, _, dt), (_, nbytes, _) in WIRE_GROUPS.items():
        out[(op, dt)] = out.get((op, dt), 0) + nbytes
    return out


def group_axes(mesh) -> Dict[str, str]:
    """{process-group name: the mesh axis it serves} (``"+"``-joined where
    one group serves several axes of ``mesh``)."""
    axes: Dict[str, str] = {}
    for a in mesh.mesh_dim_names:
        g = mesh.get_group(a).group_name
        axes[g] = axes[g] + "+" + a if g in axes else a
    return axes


class CollectiveLog(TorchDispatchMode):
    """While active (``with CollectiveLog(mesh) as log:``), every
    functional collective, which is how DTensor moves data, adds to
    ``log.counts[(op, axis, dtype)] = [launches, bytes, largest numel]``.
    ``axis`` names the mesh axis whose group carried it (``"+"``-joined
    where one group serves several axes of ``mesh``, ``"?"`` for a group
    that is not one of ``mesh``'s). The collectives this module hands to
    ``torch.distributed`` are counted in :data:`WIRE_GROUPS` instead.
    PyTorch's ``CommDebugMode`` counts by op only, and so cannot say which
    axis a reduction ran over."""

    def __init__(self, mesh):
        from torch.distributed.tensor import DTensor

        super().__init__()
        self._dtensor = DTensor
        self.axes = group_axes(mesh)
        self.counts: Dict[Tuple[str, str, str], list] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(t is self._dtensor for t in types):
            return NotImplemented  # let DTensor desugar into collectives
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__.rstrip("_")
        if func.namespace in ("_c10d_functional", "c10d_functional") \
                and name not in NOT_COLLECTIVES:
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            ts = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            key = (name, self.axes.get(group, "?"),
                   str(ts[0].dtype).replace("torch.", ""))
            rec = self.counts.setdefault(key, [0, 0, 0])
            rec[0] += 1
            rec[1] += sum(t.numel() * t.element_size() for t in ts)
            rec[2] = max(rec[2], max(t.numel() for t in ts))
        return out

    def reductions_over(self, axis: str) -> int:
        """The largest tensor (elements) that an ``all_reduce`` or a
        ``reduce_scatter`` carried over a group serving ``axis``; 0 if
        none ran."""
        return max((n for (op, ax, _), (_, _, n) in self.counts.items()
                    if op.startswith(("all_reduce", "reduce_scatter"))
                    and (axis in ax.split("+") or ax == "?")), default=0)


def _count(op: str, t: torch.Tensor, group) -> None:
    group = group if group is not None else dist.group.WORLD
    key = (op, group.group_name, str(t.dtype).replace("torch.", ""))
    rec = WIRE_GROUPS.get(key)
    if rec is None:
        rec = WIRE_GROUPS[key] = [0, 0, dist.get_world_size(group)]
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[W, *x.shape]: every rank's ``x`` over ``group``
    (``all_gather_into_tensor``, ``x``'s dtype on the wire)."""
    w = dist.get_world_size(group)
    flat = x.reshape(-1).contiguous()
    out = torch.empty((w * flat.numel(),), dtype=x.dtype, device=x.device)
    _count("all_gather", x, group)
    with warnings.catch_warnings():  # newer releases rename it
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, flat, group=group)
    return out.reshape((w,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [W, ...]: row ``r`` goes to rank ``r``; returns [W, ...] whose
    row ``r`` came from rank ``r`` (``all_to_all_single``)."""
    out = torch.empty_like(x)
    _count("all_to_all", x, group)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def ring_shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """``x`` sent to the rank ``step`` places on in ``group``'s order (a
    ring); returns what the rank ``step`` places back sent. The roll over
    a blocked axis (``sharding.roll_blocks``) moves its boundary slab
    through it: the counterpart of XLA's collective-permute."""
    w = dist.get_world_size(group)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % w)
    src = dist.get_global_rank(group, (r - step) % w)
    out = torch.empty_like(x)
    _count("permute", x, group)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """In-place max of a (scalar) tensor over ``group``."""
    _count("all_reduce_max", x, group)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def int8_scale(amax, eps: float = 1e-12):
    """The f32 scale of int8 levels for a largest magnitude ``amax``:
    ``max(amax, eps) / 127`` as XLA compiles the reference's jitted
    quantizers, a product with the f32 reciprocal (one ulp off the
    quotient at some inputs)."""
    return torch.clamp(amax, min=eps) * (1.0 / 127.0)


def int8_residual(g, q, scale):
    """``g - q * scale`` rounded once, as the fused multiply-add XLA
    compiles there: ``q * scale`` (a 7-bit integer times an f32) is exact
    in f64, and so is its difference with ``g``."""
    return (g.to(torch.float64) - q.to(torch.float64)
            * scale.to(torch.float64)).to(torch.float32)


def _quantize_int8(g, eps: float = 1e-12):
    """(int8 levels as float, f32 scale, residual); ``torch.round`` rounds
    half to even, as ``jnp.round``."""
    scale = int8_scale(torch.max(torch.abs(g)), eps)
    q = torch.clamp(torch.round(g / scale), -127.0, 127.0)
    return q, scale, int8_residual(g, q, scale)


def quantized_allgather_sum(q, scale, group):
    """All-gather int8 levels and the per-rank scales over ``group`` and
    dequant-sum locally (all-reduce semantics, int8 on the wire). ``q``
    holds int8-representable float levels."""
    q8 = all_gather(q.to(torch.int8), group)                  # [W, ...] int8
    scales = all_gather(scale.reshape(()).to(torch.float32), group)  # [W]
    return torch.sum(q8.to(torch.float32)
                     * scales.reshape((-1,) + (1,) * q.dim()), dim=0)


def make_compressed_psum(mesh, axis: str):
    """``f(x, err) -> (summed, new_err)`` over mesh axis ``axis``: ``x`` and
    ``err`` are this rank's rows (the reference's global arrays sharded on
    their leading dim over ``axis``, as local [1, ...] blocks or DTensors);
    every rank gets the full reduction in its row."""
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis)

    def f(x, err):
        wrap = is_dtensor(x)
        xl = x.to_local() if wrap else x
        el = err.to_local() if is_dtensor(err) else err
        g = xl.to(torch.float32) + el.to(torch.float32)
        q, scale, residual = _quantize_int8(g)
        total = quantized_allgather_sum(q, scale, group)
        out = total.to(xl.dtype), residual.to(el.dtype)
        if wrap:
            out = tuple(DTensor.from_local(t, x.device_mesh, x.placements,
                                           run_check=False) for t in out)
        return out

    return f
