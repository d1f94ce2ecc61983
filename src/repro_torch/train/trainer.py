"""Training loop with checkpoint/restart, straggler monitoring, and
deterministic data resume — port of ``repro.train.trainer``, the engine the
launcher drives (one process, or every rank of a mesh in lockstep).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.dist.fault_tolerance import HeartbeatMonitor, WorkerLost
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.optim.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3


def _wait(t) -> None:
    """The step's clock stops when its work is done: wait for the device
    that holds ``t`` (the reference's ``jax.block_until_ready``)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _save_kwargs(ctx, axes) -> dict:
    """``CheckpointManager.save``'s sharding arguments: on a ``DeviceMesh``
    every rank of it writes the shards dealt to it (its flat position in
    the mesh is its process index) and the ranks meet at a barrier over
    each mesh dim in turn, which together wait for the whole mesh."""
    if ctx is None:
        return {}
    kw = {"ctx": ctx, "axes": axes}
    mesh = ctx.mesh
    if hasattr(mesh, "get_group"):
        import torch.distributed as dist

        ranks = mesh.mesh.reshape(-1).tolist()
        groups = [mesh.get_group(i) for i in range(mesh.ndim)]

        def barrier():
            for g in groups:
                dist.barrier(group=g)

        kw.update(process_index=ranks.index(dist.get_rank()),
                  process_count=len(ranks), barrier=barrier)
    return kw


def train_loop(cfg: ModelConfig, params, data_iter, opt_cfg: AdamWConfig,
               loop_cfg: TrainLoopConfig, train_step=None, monitor=None,
               log_fn=print, sharding_ctx=None, state_axes=None,
               tracer: Optional[Tracer] = None,
               metrics_registry: Optional[MetricsRegistry] = None,
               **fw_kwargs):
    """Runs the loop; resumes from the latest complete checkpoint if present.

    Returns (params, opt_state, history). ``params`` is a parameter tree on
    the device the loop trains on (``data_iter(step)``'s numpy batches are
    moved there); ``train_step`` may be a step the launcher built;
    defaults to :func:`make_train_step` (a plain function, no
    ``torch.compile``), which writes each update into the tensors it is
    given: the caller's ``params`` are consumed. When the heartbeat monitor declares workers dead,
    the loop raises :class:`WorkerLost` so the launcher can re-plan and
    re-enter; the checkpoint restore at the top of this function is the
    other half of that dance.

    ``tracer``/``metrics_registry`` opt into the ``repro_torch.obs``
    substrate: per-step ``train/step`` spans on the "train" track,
    ``ckpt/save`` / ``ckpt/restore`` spans, a ``worker/lost`` instant
    before the :class:`WorkerLost` raise, and ``train.*`` metrics (steps,
    step-time histogram, loss/grad-norm gauges). Defaults are the
    zero-overhead no-ops.

    ``sharding_ctx`` + ``state_axes`` (logical axes mirroring
    ``{"params", "opt"}``) switch checkpointing to per-shard writes (each
    rank of the mesh writes its own) and lay restored state out on the
    current mesh — which may differ from the mesh the checkpoint was saved
    under (elastic restart).
    """
    save_kw = _save_kwargs(sharding_ctx, state_axes)
    tr = tracer if tracer is not None else NULL_TRACER
    reg = metrics_registry if metrics_registry is not None \
        else MetricsRegistry()
    c_steps = reg.counter("train.steps")
    c_saves = reg.counter("train.ckpt.saves")
    c_restores = reg.counter("train.ckpt.restores")
    h_step = reg.histogram("train.step_time_s")
    g_loss = reg.gauge("train.loss")
    g_gnorm = reg.gauge("train.grad_norm")

    opt_state = init_state(params, opt_cfg)
    step0 = 0
    ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep_ckpts) \
        if loop_cfg.ckpt_dir else None
    if ckpt is not None:
        t0 = tr.now()
        restored = ckpt.restore_latest({"params": params, "opt": opt_state},
                                       ctx=sharding_ctx, axes=state_axes)
        if restored is not None:
            state, step0 = restored
            params, opt_state = state["params"], state["opt"]
            c_restores.inc()
            tr.span("ckpt/restore", t0, round_idx=step0, track=("train", 0),
                    step=step0)
            log_fn(f"[trainer] resumed from step {step0}")

    if train_step is None:
        train_step = make_train_step(cfg, opt_cfg, **fw_kwargs)
    # default monitor: deaths only via mark_dead — a wall-clock timeout here
    # would let a single slow save make the lone worker declare *itself*
    # dead; launchers pass a real fleet monitor
    monitor = monitor or HeartbeatMonitor(num_workers=1,
                                          timeout_s=float("inf"))

    history = []
    for step in range(step0, loop_cfg.total_steps):
        batch = data_iter(step)
        t_span = tr.now()
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        _wait(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.beat(0, step, dt)
        c_steps.inc()
        h_step.observe(dt)
        tr.span("train/step", t_span, round_idx=step, track=("train", 0),
                step=step)
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            g_loss.set(m["loss"])
            g_gnorm.set(m["grad_norm"])
            history.append({"step": step, "time_s": dt, **m})
            log_fn(f"[trainer] step={step} loss={m['loss']:.4f} "
                   f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} {dt*1e3:.0f}ms")
        if ckpt is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            t0 = tr.now()
            ckpt.save({"params": params, "opt": opt_state}, step + 1,
                      **save_kw)
            c_saves.inc()
            tr.span("ckpt/save", t0, round_idx=step + 1, track=("train", 0),
                    step=step + 1)
        dead = monitor.dead_workers()
        if dead:
            tr.instant("worker/lost", round_idx=step + 1, track=("train", 0),
                       workers=sorted(dead), step=step + 1)
            raise WorkerLost(dead, step=step + 1, history=history)
    # no final save when the loop never ran (restored step >= total_steps):
    # it would relabel the newer restored state as step_total_steps and
    # rewrite genuine history
    if ckpt is not None and step0 < loop_cfg.total_steps:
        t0 = tr.now()
        ckpt.save({"params": params, "opt": opt_state}, loop_cfg.total_steps,
                  **save_kw)
        c_saves.inc()
        tr.span("ckpt/save", t0, round_idx=loop_cfg.total_steps,
                track=("train", 0), step=loop_cfg.total_steps)
    return params, opt_state, history
