"""Training step: microbatched gradient accumulation + AdamW — port of
``repro.train.train_step`` for one device.

The loss and its gradients come from ``torch.autograd.grad`` on detached
leaf views of the parameters (no copy); the step then writes its update
into the parameters and optimizer state it was given, as the reference
launcher's jit with donated arguments does. Microbatching follows the
reference's scan: the batch splits along its leading dim as
``(nm, B / nm)``, the gradients are summed in f32 and scaled by
``1 / nm``, the loss averaged; with one microbatch the gradients keep the
parameters' dtype, as ``jax.value_and_grad`` gives them. The forward runs
the plain ops: the kernels have no backward (``api.lm_loss`` raises for
``use_kernels`` under autograd), as the reference trains.

On a mesh (``mesh=``, a ``DeviceMesh`` named ``("data", "model")``) the
parameters and optimizer state are DTensors laid out by ``TRAIN_RULES``
(``dist/sharding.py``) and the step runs under ``use_sharding``: every rank
builds the same global batch from the deterministic pipeline and keeps its
``batch@data`` rows. With ``compress_grads`` the gradient reduction over
``data`` is the two-phase int8 collective of :func:`_make_compressed_step`;
without a mesh ``compress_grads`` is the local error-feedback model inside
``apply_updates``, as in the reference.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx, current_ctx,
                                       is_dtensor, local_dtensor, mesh_sizes,
                                       shard_act, use_sharding, vmap_logical)
from repro_torch.models import api as model_api
from repro_torch.optim.optimizer import AdamWConfig, apply_updates
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)


def batch_to(batch: dict, device) -> dict:
    """The batch's arrays (numpy, from the data pipeline, or tensors) as
    tensors on ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _device(params):
    return tree_leaves(params)[0].device


def loss_and_grads(cfg: ModelConfig, params, batch: dict, **fw_kwargs):
    """(loss, gradient tree in the parameters' dtypes) of ``api.lm_loss``.
    Leaves the loss does not reach get zeros, as ``jax.grad`` gives
    them."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = model_api.lm_loss(tree_unflatten(treedef, leaves), cfg,
                                 batch, **fw_kwargs)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def step_loss_and_grads(cfg: ModelConfig, params, batch: dict,
                        num_microbatches: int = 1, **fw_kwargs):
    """(loss, gradients) of one step's ``batch`` (tensors on the params'
    device). With ``num_microbatches`` > 1 the batch splits along its
    leading dim as ``(nm, B / nm)``, the gradients are summed in f32 and
    scaled by ``1 / nm`` and the loss averaged, as the reference's scan."""
    nm = num_microbatches
    if nm == 1:
        return loss_and_grads(cfg, params, batch, **fw_kwargs)

    def split(x):
        if is_dtensor(x) and nm % _row_ways(x):
            # the microbatch dim cannot take the rows' mesh dims (8
            # microbatches of a batch on 16 data ranks): the rows are made
            # whole first, then each microbatch is laid out by shard_act
            x = x.redistribute(x.device_mesh, _rows_whole(x))
        x = x.reshape((nm, x.shape[0] // nm) + x.shape[1:])
        return shard_act(x, (None, "batch") + (None,) * (x.dim() - 2))

    mbs = {k: split(v) for k, v in batch.items()}
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
    lsum = torch.zeros((), dtype=torch.float32, device=_device(params))
    for i in range(nm):
        l_, g = loss_and_grads(cfg, params, {k: v[i] for k, v in mbs.items()},
                               **fw_kwargs)
        for acc, gi in zip(tree_leaves(gsum), tree_leaves(g)):
            acc.add_(gi)  # f32 += grad, as the reference's f32 sum
        del g
        lsum = lsum + l_
    inv = 1.0 / nm
    for acc in tree_leaves(gsum):
        acc.mul_(inv)
    return lsum * inv, gsum


def _row_ways(x) -> int:
    """How many ranks split dim 0 of DTensor ``x``."""
    from torch.distributed.tensor import Shard

    return math.prod(s for p, s in zip(x.placements, x.device_mesh.shape)
                     if isinstance(p, Shard) and p.dim == 0)


def _rows_whole(x) -> list:
    """``x``'s placements with dim 0 whole on every mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
            for p in x.placements]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, mesh=None, **fw_kwargs):
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as
    device scalars. The update is written into the storage of ``params``
    and ``opt_state``, which are returned (``apply_updates(donate=True)``,
    the counterpart of the reference launcher's donated jit arguments):
    the caller's trees hold the new values after the call.

    ``mesh``: the parameters and state are DTensors on it (the trainer lays
    them out); the batch (the same global arrays on every rank) is laid
    out ``batch@data`` and the step runs under the ambient ``use_sharding``
    context, or ``TRAIN_RULES`` on ``mesh`` without one. ``mesh`` with
    ``opt_cfg.compress_grads`` is the wire-compressed step
    (:func:`_make_compressed_step`; one microbatch). Metrics come back as
    plain tensors."""
    if opt_cfg.compress_grads and mesh is not None:
        if num_microbatches != 1:
            raise NotImplementedError(
                "compressed wire reduction assumes num_microbatches == 1 "
                "(each data shard quantizes one local gradient per step)")
        return _make_compressed_step(cfg, opt_cfg, mesh, **fw_kwargs)

    def train_step(params, opt_state, batch):
        with _on_mesh(mesh) as ctx:
            batch = mesh_batch(batch, ctx, _device(params))
            loss, grads = step_loss_and_grads(cfg, params, batch,
                                              num_microbatches, **fw_kwargs)
            with torch.no_grad():
                params, opt_state, metrics = apply_updates(
                    params, grads, opt_state, opt_cfg, donate=True)
            metrics["loss"] = loss
            metrics = {k: _plain(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


@contextlib.contextmanager
def _on_mesh(mesh):
    """The step's sharding context: the ambient ``use_sharding`` context
    on a ``DeviceMesh`` (the launcher's), else ``TRAIN_RULES`` on ``mesh``,
    else None (one device); on a mesh the model's plain constants (RoPE's
    frequencies, aranges, scalars) are taken as replicated."""
    from torch.distributed.device_mesh import DeviceMesh

    ctx = current_ctx()
    if ctx is not None and not isinstance(ctx.mesh, DeviceMesh):
        ctx = None
    if ctx is None and mesh is None:
        yield None
        return
    from torch.distributed.tensor.experimental import implicit_replication

    ctx = ctx or ShardingCtx(mesh, TRAIN_RULES)
    with use_sharding(ctx.mesh, ctx.rules), implicit_replication():
        yield ctx


def mesh_batch(batch: dict, ctx, device) -> dict:
    """The batch's arrays as tensors on ``device``; under a ctx each is a
    DTensor laid out ``("batch", None, ...)`` from the global array every
    rank holds (each rank keeps its rows, nothing on the wire)."""
    batch = batch_to(batch, device)
    if ctx is None:
        return batch
    return {k: local_dtensor(v, ctx.mesh, ctx.placements(
        ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape)))
        for k, v in batch.items()}


def _plain(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if is_dtensor(t) else t


def _model_placement(p):
    """(placement on ``model``, the mesh dim index) of a DTensor leaf."""
    names = p.device_mesh.mesh_dim_names
    md = names.index("model")
    return p.placements[md], md


def _make_compressed_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                          **fw_kwargs):
    """Train step whose gradient reduction over ``data`` moves int8.

    Each data rank computes its own group's gradient (its ``B / W`` rows of
    the batch, the group's own mean loss) with the parameters gathered on
    ``data`` and still laid out on ``model``, as DTensors on the ``model``
    sub-mesh: nothing of the group's backward touches ``data``, so no f32
    gradient is reduced there (a DTensor backward over the whole mesh would
    give a replicated parameter a partial gradient, and reducing it is the
    f32 all-reduce this step avoids). The reduction is then the reference's
    two-phase compressed all-reduce, on each rank's ``model`` shard of each
    leaf:

      phase 1  int8 quantize ``g / W + err`` with one f32 scale for the
               group's whole leaf (a max over ``model``), then an int8
               ``all_to_all`` over ``data``, column chunk by chunk: every
               rank receives all groups' levels of its chunk;
      local    dequantize and sum the W groups;
      phase 2  quantize the chunk sums with one global scale (a max over
               the whole mesh) and ``all_gather`` the int8.

    ~2 bytes a parameter on the wire against ~8 for an f32 ring
    all-reduce. The residual ``err`` rides a leading [W] "groups" dim on
    ``data`` (``init_state(..., grad_shards=W)``; at W = 1 it has the
    parameter's shape, as the reference's). The per-element math is
    the reference's whatever the chunking, since both scales are maxima
    over the whole leaf. The scales and the residual are computed as XLA
    compiles the reference's (``collectives.int8_scale``,
    ``int8_residual``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ways = mesh_sizes(mesh)["data"]
    d_dim = mesh.mesh_dim_names.index("data")
    data_g = mesh.get_group("data")
    model_mesh = mesh["model"]
    model_g = mesh.get_group("model")
    vgrad = vmap_logical(
        lambda p, mb: loss_and_grads(cfg, p, mb, **fw_kwargs), "groups")

    def group_param(p):
        pl, md = _model_placement(p)
        lay = list(p.placements)
        lay[d_dim] = Replicate()  # the FSDP gather of the group's params
        full = p.redistribute(mesh, lay)
        return DTensor.from_local(full.to_local(), model_mesh, [pl],
                                  run_check=False)

    def one(g, e, p):
        """(reduced grad, new residual) of one leaf: DTensors on mesh."""
        pl, md = _model_placement(p)
        g = g.redistribute(model_mesh, [pl])  # TP's own reduction
        gl = g.to_local().to(torch.float32)
        grouped = e.dim() == p.dim() + 1  # W = 1 keeps no groups dim
        el = e.to_local()[0] if grouped else e.to_local()
        g32 = gl / ways + el
        split_on_model = isinstance(pl, Shard)
        m = g32.numel()
        mp = -(-m // ways) * ways  # chunk-pad so columns split evenly
        flat = torch.nn.functional.pad(g32.reshape(-1), (0, mp - m))
        # phase 1: the group's levels, sent column chunk by chunk
        scale1 = torch.max(torch.abs(flat)).reshape(1)
        if split_on_model:
            coll.all_reduce_max(scale1, model_g)
        scale1 = coll.int8_scale(scale1)
        q = torch.clamp(torch.round(flat / scale1), -127.0, 127.0)
        q8 = coll.all_to_all(q.to(torch.int8).reshape(ways, mp // ways),
                             data_g)
        s1 = coll.all_gather(scale1.reshape(()), data_g)  # [W] f32
        tot = q8[0].to(torch.float32) * s1[0]
        for w in range(1, ways):
            tot = tot + q8[w].to(torch.float32) * s1[w]
        # phase 2: one global scale for the summed chunks
        scale2 = torch.max(torch.abs(tot)).reshape(1)
        coll.all_reduce_max(scale2, data_g)
        if split_on_model:
            coll.all_reduce_max(scale2, model_g)
        scale2 = coll.int8_scale(scale2)
        q2 = torch.clamp(torch.round(tot / scale2), -127.0, 127.0)
        q2 = coll.all_gather(q2.to(torch.int8), data_g)   # [W, chunk] int8
        total = (q2.reshape(-1).to(torch.float32) * scale2)[:m]
        # residual from the phase-1 dequant only: phase-2 error is shared
        new_e = coll.int8_residual(g32.reshape(-1), q[:m],
                                   scale1).reshape(g32.shape)
        lay = list(p.placements)
        lay[d_dim] = Replicate()
        lay[md] = pl
        return (DTensor.from_local(total.reshape(gl.shape), mesh, lay,
                                   run_check=False),
                DTensor.from_local(new_e[None] if grouped else new_e, mesh,
                                   e.placements, run_check=False))

    def train_step(params, opt_state, batch):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        ctx = current_ctx() or ShardingCtx(mesh, TRAIN_RULES)
        coord = mesh.get_coordinate()[d_dim]
        full = batch_to(batch, _device(params))
        local = {k: v.reshape((ways, v.shape[0] // ways) + v.shape[1:])
                 [coord] for k, v in full.items()}
        with implicit_replication():
            with use_sharding(model_mesh, ctx.rules):
                gp = tree_map(group_param, params)
                mb = {k: DTensor.from_local(v, model_mesh, [Replicate()],
                                            run_check=False)
                      for k, v in local.items()}
                loss, grads = vgrad(gp, mb)
                del gp
            pairs = [one(g, e, p) for g, e, p in zip(
                tree_leaves(grads), tree_leaves(opt_state["err"]),
                tree_leaves(params))]
            del grads
            _, treedef = tree_flatten(params)
            red = tree_unflatten(treedef, [a for a, _ in pairs])
            new_err = tree_unflatten(treedef, [b for _, b in pairs])
            del pairs
            with torch.no_grad():
                params, opt_state, metrics = apply_updates(
                    params, red, opt_state, opt_cfg, reduced_err=new_err,
                    donate=True)
            lay = [Replicate()] * mesh.ndim
            lay[d_dim] = Shard(0)
            losses = DTensor.from_local(loss.to_local().reshape(1), mesh,
                                        lay, run_check=False)
            metrics["loss"] = torch.mean(losses)
            metrics = {k: _plain(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, mesh=None, **fw_kwargs):
    """Returns ``eval_step(params, batch) -> loss``, forward only (no
    autograd), so ``cfg.use_kernels`` may route the norms, the attention
    and the SSD chunk block through the CUDA kernels. On a ``mesh`` (DTensor
    params) the batch is laid out as in the train step and each kernel runs
    on every rank's local shard (``kernels/mesh.py``); the loss comes back
    as a plain tensor."""
    def eval_step(params, batch):
        with torch.no_grad(), _on_mesh(mesh) as ctx:
            return _plain(model_api.lm_loss(
                params, cfg, mesh_batch(batch, ctx, _device(params)),
                **fw_kwargs))

    return eval_step
