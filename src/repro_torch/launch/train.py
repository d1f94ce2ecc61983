"""Distributed training launcher with elastic restart — port of
``repro.launch.train``.

Builds the train step for an arch, wires the data pipeline, the
checkpoint manager and the heartbeat monitor, and runs a *resumable*
loop: when the monitor declares workers dead the trainer raises
``WorkerLost``, and this launcher re-plans the mesh (``plan_elastic_mesh``),
builds it over the surviving ranks, restores the latest sharded checkpoint
onto it, rebalances the data-pipeline host split, and re-enters the loop.

Torch is multi-controller: with ``--mesh DxM`` the launcher spawns D*M
ranks itself (a FileStore rendezvous in a temporary directory; gloo with
``--device cpu``, NCCL on the card, a card a rank) unless
``torchrun`` started it (``RANK``/``WORLD_SIZE`` in the environment). Every
rank builds the same global batch from the deterministic pipeline and
keeps its rows; rank 0 prints. After a re-plan every rank takes part in
building the new mesh's groups, and the ranks outside it leave the loop.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Demonstrate the elastic dance end-to-end (kills fake host 1 at step 20,
shrinks the fleet, resumes from the last checkpoint):

  ... --hosts 2 --ckpt-dir /tmp/ckpt --ckpt-every 10 --simulate-dead-at 20

On a mesh of two ranks that loses one of them (re-plans to (1,1)):

  ... --device cpu --mesh 2x1 --hosts 2 --ckpt-dir /tmp/ckpt \\
      --ckpt-every 3 --simulate-dead-at 4

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.fault_tolerance import (HeartbeatMonitor, WorkerLost,
                                              plan_elastic_mesh,
                                              survivor_split)
from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                       distribute_tree, use_sharding)
from repro_torch.models import api as model_api
from repro_torch.optim import AdamWConfig, state_axes
from repro_torch.train import TrainLoopConfig, train_loop
from repro_torch.train.train_step import make_train_step
from repro_torch.utils import pspec
from repro_torch.utils.tree import tree_leaves


class FailureInjector(HeartbeatMonitor):
    """Heartbeat monitor that declares one worker dead at a given step —
    drives the elastic-restart path without needing a real host to die."""

    def __init__(self, num_workers: int, dead_at=None, dead_worker: int = 1,
                 **kw):
        kw.setdefault("timeout_s", float("inf"))  # deaths only via injection
        super().__init__(num_workers, **kw)
        self._dead_at = dead_at
        self._dead_worker = dead_worker

    def beat(self, worker: int, step: int, duration_s: float):
        super().beat(worker, step, duration_s)
        if self._dead_at is not None and step + 1 >= self._dead_at:
            self.mark_dead(self._dead_worker)
            self._dead_at = None


def _merge_history(entries):
    """Last write wins for rewound steps: a restart replays everything since
    the restored checkpoint, so drop a pre-failure entry whenever a later
    attempt re-ran its step (or an earlier one)."""
    out = []
    lo = None
    for e in reversed(entries):
        if lo is None or e["step"] < lo:
            out.append(e)
            lo = e["step"]
    out.reverse()
    return out


def _build_state_axes(cfg, opt_cfg):
    """Logical-axes tree mirroring the {"params", "opt"} checkpoint state."""
    ax = pspec.logical_axes(model_api.model_specs(cfg))
    return {"params": ax, "opt": state_axes(ax, opt_cfg)}


def make_step_factory(cfg, opt_cfg, num_microbatches: int = 1,
                      on_mesh: bool = False):
    """``step_factory(data_parallel)`` of :func:`elastic_train`: the train
    step with remat, its update written into the params and optimizer
    state it is given (the reference jits it with them donated). MoE
    routing groups track the (possibly shrunken) data axis on a mesh, one
    group on one device."""
    def step_factory(data_parallel: int):
        fw = {"remat": True}
        if cfg.family == "moe":
            fw["num_groups"] = data_parallel if on_mesh else 1
        return make_train_step(cfg, opt_cfg,
                               num_microbatches=num_microbatches, **fw)

    return step_factory


def _check_chips(mesh_shape, chips_per_host) -> None:
    """More than one chip a host only sizes a mesh's elastic plan."""
    if mesh_shape is None and chips_per_host != 1:
        raise ValueError(f"chips_per_host={chips_per_host} without a mesh: "
                         "the chips of a host only size the elastic plan of "
                         "--mesh")


def elastic_train(cfg, params, pipe, opt_cfg, loop_cfg, *, step_factory,
                  mesh_shape=None, total_hosts=1, chips_per_host=1,
                  monitor_factory=None, log_fn=print, max_restarts=4):
    """The resumable loop: train until done or out of healthy hosts.

    ``mesh_shape`` is (data, model) or None for one device; with a mesh,
    every rank of the initialized default process group calls this with
    the same arguments (``params`` the same full tensors on each).
    ``step_factory(data_parallel)`` builds the train step for the current
    data-parallel ways — rebuilt per attempt because step internals (MoE
    ``num_groups``) must track the shrunken mesh. Each attempt also gets a
    fresh monitor for the current fleet (a new incarnation must not
    inherit tombstones from the previous one). A rank outside a re-planned
    mesh returns ``(None, None, history so far)``.
    """
    _check_chips(mesh_shape, chips_per_host)
    # single-process fleets: only worker 0 ever beats, so wall-clock
    # timeouts would spuriously declare the simulated hosts dead — deaths
    # arrive via mark_dead only
    monitor_factory = monitor_factory or (
        lambda n: HeartbeatMonitor(num_workers=n, timeout_s=float("inf")))
    device = tree_leaves(params)[0].device
    ckpt_axes = _build_state_axes(cfg, opt_cfg)
    dead_total: set = set()
    my_host = 0  # this process's id in the *original* fleet numbering
    past_history = []  # metrics from attempts that ended in WorkerLost

    for attempt in range(max_restarts + 1):
        alive = total_hosts - len(dead_total)
        ctx = None
        d = 1
        if mesh_shape is not None:
            from repro_torch.launch.mesh import make_mesh

            d, m = mesh_shape
            if dead_total:
                plan = plan_elastic_mesh(
                    total_hosts, len(dead_total),
                    chips_per_host=chips_per_host, model_parallel=m,
                    max_data=max(1, d))
                d = plan.data_parallel
                log_fn(f"[launch] elastic plan after losing "
                       f"{sorted(dead_total)}: mesh=({d},{m}) "
                       f"idle={plan.idle_devices}")
            mesh = make_mesh((d, m), ("data", "model"), device=device.type)
            if mesh.get_coordinate() is None:  # outside the new mesh
                return None, None, _merge_history(past_history)
            ctx = ShardingCtx(mesh, TRAIN_RULES)
            params = distribute_tree(params, ctx, ckpt_axes["params"])
        monitor = monitor_factory(alive)
        step_fn = step_factory(d)
        try:
            if ctx is not None:
                with use_sharding(ctx.mesh, TRAIN_RULES):
                    p, o, hist = train_loop(
                        cfg, params, pipe, opt_cfg, loop_cfg,
                        train_step=step_fn, monitor=monitor, log_fn=log_fn,
                        sharding_ctx=ctx, state_axes=ckpt_axes)
            else:
                p, o, hist = train_loop(cfg, params, pipe, opt_cfg,
                                        loop_cfg, train_step=step_fn,
                                        monitor=monitor, log_fn=log_fn)
            return p, o, _merge_history(past_history + hist)
        except WorkerLost as e:
            past_history.extend(e.history)
            # dead worker ids are indices into the *current* incarnation;
            # map them back to original host ids before compacting
            survivors = [h for h in range(total_hosts) if h not in dead_total]
            unknown = [w for w in e.workers if w >= len(survivors)]
            if unknown:
                raise RuntimeError(
                    f"WorkerLost reported worker ids {unknown} outside the "
                    f"{len(survivors)}-host fleet (bad --simulate-dead-"
                    f"worker?)") from e
            newly_dead = {survivors[w] for w in e.workers}
            dead_total |= newly_dead
            log_fn(f"[launch] {e}; hosts {sorted(newly_dead)} lost "
                   f"({total_hosts - len(dead_total)}/{total_hosts} alive)")
            # all bookkeeping stays in original host ids; only the pipeline
            # split uses the compacted index, recomputed fresh each time
            split = survivor_split(total_hosts, dead_total)
            if my_host in dead_total:
                raise RuntimeError("this host was declared dead") from e
            host_index = split[my_host]
            # the survivor count must divide the global batch; otherwise
            # idle the fewest hosts that make it divide (they stay healthy
            # spares) rather than dying with 3 good hosts and a checkpoint
            new_count = max(h for h in range(1, len(split) + 1)
                            if pipe.global_batch % h == 0)
            if new_count < len(split):
                log_fn(f"[launch] batch {pipe.global_batch} not divisible "
                       f"by {len(split)} survivors; idling "
                       f"{len(split) - new_count} host(s)")
            if host_index >= new_count:
                raise RuntimeError(
                    "this host was idled by the rebalance") from e
            pipe = pipe.rebalance(host_index, new_count)
            if loop_cfg.ckpt_dir is None:
                log_fn("[launch] WARNING: no --ckpt-dir; restarting from "
                       "scratch, all pre-failure progress is lost")
            # the donated step wrote into the in-memory params; re-make a
            # template (values are overwritten by the checkpoint restore
            # inside train_loop on re-entry)
            params = model_api.init_model(cfg, 0, device=device)
    raise RuntimeError(f"gave up after {max_restarts} elastic restarts")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="", help="e.g. 2x2 => (data=2, model=2)"
                    "; spawns the ranks unless torchrun started them")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--hosts", type=int, default=1,
                    help="fleet size for the heartbeat/elastic machinery")
    ap.add_argument("--chips-per-host", type=int, default=1,
                    help="a mesh's chips a host (sizes the elastic plan)")
    ap.add_argument("--simulate-dead-at", type=int, default=None,
                    help="mark a worker dead at this step (elastic demo)")
    ap.add_argument("--simulate-dead-worker", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _mesh_shape(spec: str):
    return tuple(int(x) for x in spec.split("x")) if spec else None


def main(argv=None, log_fn=print):
    """Returns the merged history (one entry per logged step). With
    ``--mesh`` and no process group yet, spawns the mesh's ranks and
    returns rank 0's history."""
    import sys

    import torch.distributed as dist

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    mesh_shape = _mesh_shape(args.mesh)
    _check_chips(mesh_shape, args.chips_per_host)
    resolve_device(args.device)  # refuse a GPU-less host before spawning
    if mesh_shape is not None and not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
            rank = int(os.environ["RANK"])
            _init_rank(args, rank, int(os.environ["WORLD_SIZE"]), None)
            if rank != 0:
                log_fn = (lambda *_: None)
        else:
            return _spawn(argv, args, mesh_shape, log_fn)
    dev = resolve_device(args.device)
    if mesh_shape is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, reduced=args.reduced)
    params = model_api.init_model(cfg, 0, device=dev)
    log_fn(f"[train] {cfg.name}: {model_api.param_count(cfg)/1e6:.2f}M "
           f"params on {dev}")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          compress_grads=args.compress_grads)
    pipe = DataPipeline(cfg, seq_len=args.seq, global_batch=args.batch,
                        host_index=0, host_count=args.hosts)
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir)

    if args.simulate_dead_at is not None:
        injector = {"armed": True}

        def monitor_factory(n):
            dead_at = args.simulate_dead_at if injector.pop("armed", None) \
                else None
            return FailureInjector(num_workers=n, dead_at=dead_at,
                                   dead_worker=args.simulate_dead_worker)
    else:
        monitor_factory = None

    _, _, history = elastic_train(
        cfg, params, pipe, opt_cfg, loop_cfg,
        step_factory=make_step_factory(cfg, opt_cfg, args.microbatches,
                                       on_mesh=mesh_shape is not None),
        mesh_shape=mesh_shape, total_hosts=args.hosts,
        chips_per_host=args.chips_per_host,
        monitor_factory=monitor_factory, log_fn=log_fn)
    if history:
        log_fn(f"[train] final loss {history[-1]['loss']:.4f} "
               f"(start {history[0]['loss']:.4f})")
    return history


def _init_rank(args, rank: int, world: int, store_path) -> None:
    """Join the default process group: gloo with ``--device cpu`` (one
    intra-op thread a rank: the ranks share the host's cores), NCCL on the
    card with each rank on its local index (``LOCAL_RANK`` under
    torchrun, else its rank)."""
    import torch.distributed as dist

    if args.device == "cpu":
        torch.set_num_threads(1)
        backend = "gloo"
    else:
        resolve_device(args.device)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    if store_path is None:
        dist.init_process_group(backend, rank=rank, world_size=world)
    else:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)


def _rank_main(rank: int, argv, world: int, tmp: str) -> None:
    import torch.distributed as dist

    args = parse_args(argv)
    _init_rank(args, rank, world, os.path.join(tmp, "store"))
    try:
        hist = main(argv, log_fn=print if rank == 0 else (lambda *_: None))
        if rank == 0:
            with open(os.path.join(tmp, "history.json"), "w") as f:
                json.dump(hist, f)
    finally:
        dist.destroy_process_group()


def _spawn(argv, args, mesh_shape, log_fn):
    """Run the mesh's D*M ranks as processes of their own (FileStore
    rendezvous in a temporary directory) and return rank 0's history."""
    import torch.multiprocessing as mp

    world = mesh_shape[0] * mesh_shape[1]
    tmp = tempfile.mkdtemp(prefix="repro_torch_launch_")
    try:
        mp.start_processes(_rank_main, args=(argv, world, tmp), nprocs=world,
                           start_method="spawn")
        with open(os.path.join(tmp, "history.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
