"""Serving launcher of the PyTorch port — counterpart of
``repro.launch.serve``.

The default serves ``chords-dit-xl`` (random weights from ``--seed``) with
the continuous-batching slot engine; ``--static`` serves the same drift
with the padded static-batch engine. ``--use-kernels`` routes the
backbone's RMSNorm and attention and the fused step+rectify(+accept) round
through the port's CUDA kernels (their plain versions on ``--device cpu``).

  python -m repro_torch.launch.serve --steps 50 --cores 8 --slots 4 \
      --use-kernels
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Flags of the reference not honored yet (``--overlap``, ``--min-slots``,
``--max-slots``, ``--device-rounds``, ``--lane-mode``, ``--trace-out``)
belong to ROADMAP.md queue 1 items 5-9.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.ode import uniform_tgrid
from repro_torch.device import resolve_device
from repro_torch.diffusion import init_wrapper, make_drift
from repro_torch.obs import format_stats
from repro_torch.serve import ChordsEngine, ContinuousEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chords-dit-xl")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cores", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="slot count S (doubles as --static max_batch)")
    ap.add_argument("--rtol", type=float, default=0.05)
    ap.add_argument("--static", action="store_true",
                    help="serve with the static-batch engine instead")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "edf", "edf-preempt"])
    ap.add_argument("--deadline-rounds", type=int, default=None,
                    help="per-request deadline in lockstep rounds from "
                         "submission (default: no deadline)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route RMSNorm, attention and the fused CHORDS "
                         "round through the port's CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.use_kernels:
        cfg = cfg.replace(use_kernels=True)
    params = init_wrapper(cfg, args.latent_dim,
                          generator=torch.Generator(device=dev)
                          .manual_seed(args.seed), device=dev)
    drift = make_drift(params, cfg)
    tgrid = uniform_tgrid(args.steps, device=dev)

    with torch.no_grad():
        if args.static:
            # the static engine stacks requests on axis 0, giving the drift
            # its [B, S, L] batch; the per-request latent is (seq, dim)
            engine = ChordsEngine(
                drift, latent_shape=(args.seq, args.latent_dim),
                n_steps=args.steps, num_cores=args.cores, tgrid=tgrid,
                max_batch=args.slots, rtol=args.rtol,
                use_kernel=args.use_kernels or None, device=dev)
            for i in range(args.requests):
                engine.submit(Request(rid=i, seed=100 + i))
            done = []
            while engine.queue:
                done += engine.step()
            for s in engine.stats:
                print(f"[serve] batch={s['batch']} rounds={s['rounds']} "
                      f"speedup={s['speedup']:.2f} wall={s['wall_s']:.2f}s")
            print(f"[serve] static: served {len(done)} requests in "
                  f"{engine.total_rounds()} rounds "
                  f"(kernel_path={engine.executor.kernel_path})")
            return

        # one slot = one request = one drift row: the model consumes
        # [B, S, L], so the per-slot latent carries an explicit batch-1 row
        engine = ContinuousEngine(
            drift, latent_shape=(1, args.seq, args.latent_dim),
            n_steps=args.steps, num_cores=args.cores, tgrid=tgrid,
            num_slots=args.slots, rtol=args.rtol, policy=args.policy,
            use_kernel=args.use_kernels or None, device=dev)
        for i in range(args.requests):
            engine.submit(Request(rid=i, seed=100 + i,
                                  deadline_rounds=args.deadline_rounds))
        done = engine.run_until_drained()
    for rid, out in done:
        print(f"[serve] request {rid:>3}: core {out.accepted_core} after "
              f"{out.rounds_used}/{args.steps} rounds ({out.speedup:.2f}x, "
              f"latency {out.latency_rounds} rounds)")
    for line in format_stats(engine.stats()):
        print(line)


if __name__ == "__main__":
    main()
