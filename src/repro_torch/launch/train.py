"""Training launcher with elastic restart — port of ``repro.launch.train``
for one device.

Builds the train step for an arch, wires the data pipeline, the
checkpoint manager and the heartbeat monitor, and runs a *resumable*
loop: when the monitor declares workers dead the trainer raises
``WorkerLost``, and this launcher compacts the surviving hosts
(``survivor_split``), rebalances the data-pipeline host split over them,
and re-enters the loop, which restores the latest checkpoint. A mesh
(``--mesh``: sharded parameters, the elastic re-mesh plan, the
wire-compressed step) is ROADMAP.md queue 1 item 14 and raises.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Demonstrate the elastic dance end-to-end (kills fake host 1 at step 20,
shrinks the fleet, resumes from the last checkpoint):

  ... --hosts 2 --ckpt-dir /tmp/ckpt --ckpt-every 10 --simulate-dead-at 20

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.fault_tolerance import (HeartbeatMonitor, WorkerLost,
                                              survivor_split)
from repro_torch.models import api as model_api
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainLoopConfig, train_loop
from repro_torch.train.train_step import make_train_step
from repro_torch.utils.tree import tree_leaves

_ITEM_14 = ("a device mesh (sharded parameters, the elastic re-mesh plan, "
            "the wire-compressed step) is ROADMAP.md queue 1 item 14 (dist)")


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


def make_step_factory(cfg, opt_cfg, num_microbatches: int = 1):
    """``step_factory(data_parallel)`` of :func:`elastic_train`: the train
    step with remat, its update written into the params and optimizer
    state it is given (the reference jits it with them donated); MoE
    routes in one group (one device)."""
    def step_factory(data_parallel: int):
        fw = {"remat": True}
        if cfg.family == "moe":
            fw["num_groups"] = 1
        return make_train_step(cfg, opt_cfg,
                               num_microbatches=num_microbatches, **fw)

    return step_factory


def _one_device(mesh_shape, chips_per_host) -> None:
    """Raise for what only a mesh uses (item 14): a mesh shape, or more
    than one chip a host (the reference reads it for the mesh plan)."""
    if mesh_shape is not None:
        raise NotImplementedError(f"mesh {mesh_shape}: {_ITEM_14}")
    if chips_per_host != 1:
        raise NotImplementedError(f"chips_per_host={chips_per_host}: "
                                  f"{_ITEM_14}")


def elastic_train(cfg, params, pipe, opt_cfg, loop_cfg, *, step_factory,
                  mesh_shape=None, total_hosts=1, chips_per_host=1,
                  monitor_factory=None, log_fn=print, max_restarts=4):
    """The resumable loop: train until done or out of healthy hosts.

    ``mesh_shape`` must be None and ``chips_per_host`` 1 (one device; a
    mesh is item 14).
    ``step_factory(data_parallel)`` builds the train step for the current
    data-parallel ways, rebuilt per attempt. Each attempt also gets a
    fresh monitor for the current fleet (a new incarnation must not
    inherit tombstones from the previous one).
    """
    _one_device(mesh_shape, chips_per_host)
    # single-process fleets: only worker 0 ever beats, so wall-clock
    # timeouts would spuriously declare the simulated hosts dead — deaths
    # arrive via mark_dead only
    monitor_factory = monitor_factory or (
        lambda n: HeartbeatMonitor(num_workers=n, timeout_s=float("inf")))
    device = tree_leaves(params)[0].device
    dead_total: set = set()
    my_host = 0  # this process's id in the *original* fleet numbering
    past_history = []  # metrics from attempts that ended in WorkerLost

    for attempt in range(max_restarts + 1):
        alive = total_hosts - len(dead_total)
        monitor = monitor_factory(alive)
        step_fn = step_factory(1)
        try:
            p, o, hist = train_loop(cfg, params, pipe, opt_cfg, loop_cfg,
                                    train_step=step_fn, monitor=monitor,
                                    log_fn=log_fn)
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
                    "; item 14, raises")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--hosts", type=int, default=1,
                    help="fleet size for the heartbeat/elastic machinery")
    ap.add_argument("--chips-per-host", type=int, default=1,
                    help="a mesh's chips a host; item 14, raises unless 1")
    ap.add_argument("--simulate-dead-at", type=int, default=None,
                    help="mark a worker dead at this step (elastic demo)")
    ap.add_argument("--simulate-dead-worker", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, log_fn=print):
    """Returns the merged history (one entry per logged step)."""
    args = parse_args(argv)
    _one_device(args.mesh or None, args.chips_per_host)
    dev = resolve_device(args.device)
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
        step_factory=make_step_factory(cfg, opt_cfg, args.microbatches),
        total_hosts=args.hosts, chips_per_host=args.chips_per_host,
        monitor_factory=monitor_factory, log_fn=log_fn)
    if history:
        log_fn(f"[train] final loss {history[-1]['loss']:.4f} "
               f"(start {history[0]['loss']:.4f})")
    return history


if __name__ == "__main__":
    main()
