"""Serving launcher of the PyTorch port — counterpart of
``repro.launch.serve``.

The default serves ``chords-dit-xl`` (random weights from ``--seed``) with
the continuous-batching slot engine; ``--arch zamba2-2.7b`` serves the
hybrid denoiser (Mamba2 layers and a shared attention block) instead.
``--static`` serves the same drift with the padded static-batch engine.
``--use-kernels`` routes the backbone's RMSNorm, attention and SSD chunk
block and the fused step+rectify(+accept) round through the port's CUDA
kernels (their plain versions on ``--device cpu``). ``--overlap`` serves
with the double-buffered speculative host loop
(``ContinuousEngine(overlap=True)``): the next round is enqueued before
the previous round's done flags are read back. ``--device-rounds R`` lets
one device program run up to R rounds: the synchronous loop reads the
flags back once per program (it leaves at the first accept), the overlap
loop rolls up to R rounds no lane can finish in. On CUDA every round
program is one CUDA graph launch (the loops need a CUDA 12.4 runtime and
driver).

``--min-slots/--max-slots`` enable demand-paged capacity: S moves along
power-of-two buckets, growing at once on queued demand and shrinking
after ``--resize-hysteresis`` rounds of low occupancy (a policy may veto a
shrink that endangers a queued deadline); every bucket's grid is built at
start-up. ``--lane-mode {exact,adaptive,draft}`` builds the engine with the
default draft+skip lane profile and serves every request in that mode
(``exact`` is bitwise the homogeneous grid; ``--lane-skip-tau`` is the
skip threshold). ``--trace-out PATH`` writes a Chrome trace-event JSON file
(request lifecycle, dispatch spans, metrics snapshot): open it in
ui.perfetto.dev, verify it with ``python -m repro_torch.obs check PATH``.

  python -m repro_torch.launch.serve --steps 50 --cores 8 --slots 4 \
      --use-kernels
  python -m repro_torch.launch.serve --arch zamba2-2.7b --use-kernels
  python -m repro_torch.launch.serve --use-kernels --overlap
  python -m repro_torch.launch.serve --use-kernels --device-rounds 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
      (one intra-op thread on the CPU; the card path keeps torch's default)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --min-slots 1 --max-slots 4 --lane-mode adaptive --trace-out t.json
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.ode import uniform_tgrid
from repro_torch.device import resolve_device
from repro_torch.diffusion import init_wrapper, make_drift
from repro_torch.obs import Tracer, format_stats
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
    ap.add_argument("--min-slots", type=int, default=None,
                    help="elastic capacity floor: S shrinks to this bucket "
                         "under sustained low occupancy (default: fixed S "
                         "= --slots; min == max disables every resize path "
                         "bit for bit)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="elastic capacity ceiling: S grows toward this "
                         "bucket when queued demand exceeds free lanes")
    ap.add_argument("--resize-hysteresis", type=int, default=8,
                    help="lockstep rounds of sustained low occupancy "
                         "before the grid pages slots out")
    ap.add_argument("--rtol", type=float, default=0.05)
    ap.add_argument("--static", action="store_true",
                    help="serve with the static-batch engine instead")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "edf", "edf-preempt"])
    ap.add_argument("--deadline-rounds", type=int, default=None,
                    help="per-request deadline in lockstep rounds from "
                         "submission (default: no deadline)")
    ap.add_argument("--overlap", action="store_true",
                    help="async double-buffered host loop: speculate the "
                         "next round's admissions, verify one round late")
    ap.add_argument("--device-rounds", type=int, default=1,
                    help="rounds one device program may run per host "
                         "readback (the multi-round device loop)")
    ap.add_argument("--lane-mode", default=None,
                    choices=["exact", "adaptive", "draft"],
                    help="serve every request in this heterogeneous-lane "
                         "mode (the engine gets the default draft+skip "
                         "lane profile; 'exact' is bitwise the homogeneous "
                         "grid). Continuous engine only")
    ap.add_argument("--lane-skip-tau", type=float, default=0.4,
                    help="stability threshold of lane step skipping "
                         "(adaptive and draft modes)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON file (request "
                         "lifecycle, dispatch spans, metrics snapshot); "
                         "verify it with `python -m repro_torch.obs check "
                         "PATH` (continuous engine only)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="route RMSNorm, attention, the SSD chunk block "
                         "and the fused CHORDS round through the port's "
                         "CUDA kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)
    if args.static and (args.lane_mode or args.trace_out):
        ap.error("--lane-mode and --trace-out need the continuous engine "
                 "(drop --static)")

    dev = resolve_device(args.device)
    if dev.type == "cpu":
        # one intra-op thread: the served tensors are small, and beside
        # other busy processes each op's thread pool waits at its barrier
        # for threads the scheduler has taken away (both loops ran past
        # 150 s beside six busy torch processes at the default count,
        # 44-51 s at one thread)
        torch.set_num_threads(1)
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
            min_slots=args.min_slots, max_slots=args.max_slots,
            resize_hysteresis=args.resize_hysteresis, overlap=args.overlap,
            lane_profile=True if args.lane_mode else None,
            lane_skip_tau=args.lane_skip_tau,
            use_kernel=args.use_kernels or None,
            tracer=Tracer() if args.trace_out else None, device=dev)
        for i in range(args.requests):
            engine.submit(Request(rid=i, seed=100 + i,
                                  deadline_rounds=args.deadline_rounds,
                                  mode=args.lane_mode or "exact"))
        done = engine.run_until_drained(
            max_rounds_on_device=args.device_rounds)
    print(f"[serve] device_rounds={args.device_rounds}")
    for rid, out in done:
        print(f"[serve] request {rid:>3}: core {out.accepted_core} after "
              f"{out.rounds_used}/{args.steps} rounds ({out.speedup:.2f}x, "
              f"latency {out.latency_rounds} rounds)")
    for line in format_stats(engine.stats()):
        print(line)
    if args.trace_out:
        doc = engine.write_trace(args.trace_out, meta={"launcher": "serve"})
        print(f"[serve] trace: {args.trace_out} "
              f"({doc['otherData']['events']} events, "
              f"{doc['otherData']['dropped']} dropped); check it with "
              f"`python -m repro_torch.obs check {args.trace_out}`")


if __name__ == "__main__":
    main()
