"""End-to-end serving demo: continuous batching vs static batching.

The same staggered request trace is served twice:

* ``ChordsEngine`` (static): requests are batched up to --max-batch and each
  batch is held until its slowest request converges; arrivals during a batch
  wait in the queue.
* ``ContinuousEngine`` (slot grid, same S = --max-batch): every lockstep
  round, free slots admit from the queue and converged slots drain, so an
  early-exiting request immediately hands its lane to the next arrival.

The demo prints both engines' total rounds-to-drain (continuous wins on any
staggered/mixed-difficulty trace) and checks that per-request outputs match
between the two engines — continuous batching changes scheduling, never
results.

``--policy {fifo,edf,edf-preempt}`` picks the admission policy for the
continuous engine (no-op on the default deadline-free trace: with no
deadlines every policy degenerates to FIFO). ``--sla`` switches to the
staggered SLA trace (``repro.serve.sched.workload``) and compares the chosen
policy against FIFO and the static engine: deadline-miss rate, preemption
count, and bit-identity of every non-preempted request's output.

``--min-slots/--max-slots/--resize-hysteresis`` turn on demand-paged
capacity for the continuous engine (power-of-two bucket ladder, sustained-
occupancy shrink hysteresis); leaving them unset — or setting
``min == max`` — is bit-for-bit the fixed-S engine.

``--use-kernels`` serves both engines through the fused Pallas
step+rectify+accept round (``repro.kernels.rectify``); on CPU the kernel
dispatches to its jnp oracle, so every output stays bitwise identical —
the printed kernel path confirms which implementation ran.

``--lanes`` demos the heterogeneous-lane operating curve instead: the same
trace is served three times on one lane-profiled continuous engine — every
request opted into ``exact``, then ``adaptive`` (stability-gated step
skipping), then ``draft`` (coarse draft lane + skipping) — printing rounds
saved and worst relative error per mode against the exact run. ``exact``
on the lane-profiled grid is asserted bitwise-identical to the homogeneous
engine (see serve/README.md, "Heterogeneous lanes").

The PyTorch/CUDA port's counterpart of ``examples/serve_diffusion.py``,
with every flag it has, plus ``--device`` (the GPU by default) and
``--seed`` (the mixture; requests draw their noise from seeds 1000 + i).
``--use-kernels`` serves both engines through the port's fused CUDA
step+rectify(+accept) kernels on the card; on the CPU they run their plain
versions, bitwise identical. ``--trace-out`` writes a trace that either
package's ``python -m repro{,_torch}.obs check`` reads.

  PYTHONPATH=src python examples/torch_serve_diffusion.py --requests 12 --cores 8
  PYTHONPATH=src python examples/torch_serve_diffusion.py --sla --policy edf-preempt
  PYTHONPATH=src python examples/torch_serve_diffusion.py --min-slots 1 --max-slots 8
  PYTHONPATH=src python examples/torch_serve_diffusion.py --lanes --rtol 0.3
  PYTHONPATH=src python examples/torch_serve_diffusion.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import GaussianMixture, uniform_tgrid
from repro_torch.device import resolve_device
from repro_torch.obs import Tracer
from repro_torch.serve import ChordsEngine, ContinuousEngine, Request
from repro_torch.serve.sched.workload import (drive, sla_demo_trace,
                                              sla_engine_kwargs)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def make_requests(n_requests: int, arrive_every: int):
    """Staggered trace: one request every ``arrive_every`` rounds."""
    reqs = [Request(rid=i, seed=1000 + i) for i in range(n_requests)]
    arrivals = [i * arrive_every for i in range(n_requests)]
    return reqs, arrivals


def serve_static(engine: ChordsEngine, reqs, arrivals):
    """Static batching against the arrival clock: a batch holds every lane
    until its slowest request converges, and can only contain requests that
    had arrived when it started."""
    done, clock = {}, 0
    pending = list(zip(arrivals, reqs))
    while pending or engine.queue:
        while pending and pending[0][0] <= clock:
            engine.submit(pending.pop(0)[1])
        if not engine.queue:
            clock = pending[0][0]  # idle until the next arrival
            continue
        done.update(dict(engine.step()))
        clock += engine.stats[-1]["rounds"]
    return done, clock


def serve_continuous(engine: ContinuousEngine, reqs, arrivals):
    done = {}
    pending = list(zip(arrivals, reqs))
    while pending or engine.queue or engine.has_inflight:
        while pending and pending[0][0] <= engine.round_count:
            engine.submit(pending.pop(0)[1])
        if not engine.queue and not engine.has_inflight:
            engine.round_count = pending[0][0]  # idle until the next arrival
            continue
        done.update(dict(engine.step()))
        if engine.round_count > 100_000:
            raise RuntimeError("did not drain")
    return done, engine.round_count


def serve_sla(args, gm, tgrid):
    """SLA trace: static ground truth + fifo vs --policy miss rates."""
    reqs, arrivals = sla_demo_trace(args.steps)

    static = ChordsEngine(gm.drift, latent_shape=tuple(args.latent),
                          n_steps=args.steps, num_cores=args.cores,
                          tgrid=tgrid, max_batch=args.max_batch, rtol=0.0,
                          device=args.device)
    for r in reqs:
        static.submit(r)
    truth = {}
    while static.queue:
        truth.update(dict(static.step()))

    results = {}
    for policy in dict.fromkeys(["fifo", args.policy]):
        eng = ContinuousEngine(gm.drift, latent_shape=tuple(args.latent),
                               n_steps=args.steps, num_cores=args.cores,
                               tgrid=tgrid, num_slots=args.max_batch,
                               rtol=0.0, policy=policy, device=args.device,
                               **sla_engine_kwargs(args.steps))
        out = drive(eng, list(reqs), list(arrivals))
        st = eng.stats()
        results[policy] = (eng, out, st)
        print(f"[serve:sla] {policy:12s} deadline misses "
              f"{st['deadline_misses']}/{st['deadline_total']} "
              f"(rate {st['deadline_miss_rate']:.2f}), "
              f"{st['preemptions']} preemptions "
              f"({st['preempted_rounds_wasted']} rounds wasted), "
              f"{st['rounds_total']} rounds to drain")
        # scheduling never changes results: every request this policy did
        # not preempt is BITWISE the static engine's output
        for rid, o in out.items():
            if rid in eng.preempted_rids:
                continue
            assert np.array_equal(_np(o.sample),
                                  _np(truth[rid].sample)), (policy, rid)
    fifo_st, pol_st = results["fifo"][2], results[args.policy][2]
    if args.policy != "fifo":
        print(f"[serve:sla] {args.policy} vs fifo: "
              f"{pol_st['deadline_misses']} vs {fifo_st['deadline_misses']} "
              f"misses at {pol_st['rounds_total']} vs "
              f"{fifo_st['rounds_total']} total rounds; non-preempted "
              f"outputs bitwise identical to the static engine")


def serve_lanes_demo(args, gm, tgrid):
    """Heterogeneous-lane curve: one trace at exact / adaptive / draft."""
    def run(mode, profile):
        eng = ContinuousEngine(gm.drift, latent_shape=tuple(args.latent),
                               n_steps=args.steps, num_cores=args.cores,
                               tgrid=tgrid, num_slots=args.max_batch,
                               rtol=args.rtol, lane_profile=profile,
                               lane_skip_tau=args.lane_skip_tau,
                               device=args.device)
        reqs, arrivals = make_requests(args.requests, args.arrive_every)
        for r in reqs:
            r.mode = mode
        out, _ = serve_continuous(eng, reqs, arrivals)
        return out, eng.stats()

    homog, _ = run("exact", None)
    outs, stats = {}, {}
    for mode in ("exact", "adaptive", "draft"):
        outs[mode], stats[mode] = run(mode, True)

    # exact on the lane-profiled grid is the homogeneous engine, bit for bit
    for rid in homog:
        assert np.array_equal(_np(homog[rid].sample),
                              _np(outs["exact"][rid].sample)), rid
    exact_rounds = {r: o.rounds_used for r, o in outs["exact"].items()}
    for mode in ("exact", "adaptive", "draft"):
        rounds = sum(o.rounds_used for o in outs[mode].values())
        errs = [
            float(np.linalg.norm(_np(o.sample)
                                 - _np(outs["exact"][rid].sample))
                  / np.linalg.norm(_np(outs["exact"][rid].sample)))
            for rid, o in outs[mode].items()]
        st = stats[mode]
        # max error can spike when a skip-accelerated lane wins the accept
        # race with an earlier (rtol-passing but less converged) emission —
        # the mean is the workload-level number the curve is quoted at
        print(f"[serve:lanes] {mode:8s} rounds={rounds:4d} "
              f"(mean {rounds / len(outs[mode]):5.2f}) "
              f"skips={st['lane_skips']:3d} promotes={st['lane_promotes']} "
              f"rel err vs exact: mean {np.mean(errs):.4f} "
              f"max {np.max(errs):.4f}")
    saved = (sum(exact_rounds.values())
             - sum(o.rounds_used for o in outs["adaptive"].values()))
    print(f"[serve:lanes] exact bitwise == homogeneous engine; adaptive "
          f"saved {saved} rounds on the same trace")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cores", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="static batch size == continuous slot count S")
    ap.add_argument("--rtol", type=float, default=0.05)
    ap.add_argument("--arrive-every", type=int, default=6,
                    help="rounds between request arrivals")
    ap.add_argument("--latent", type=int, nargs=2, default=(64, 16),
                    metavar=("SEQ", "DIM"))
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "edf", "edf-preempt"])
    ap.add_argument("--sla", action="store_true",
                    help="run the deadline demo trace instead")
    ap.add_argument("--lanes", action="store_true",
                    help="demo the heterogeneous-lane operating curve "
                         "(exact / adaptive / draft on one lane-profiled "
                         "engine) instead")
    ap.add_argument("--lane-skip-tau", type=float, default=0.2,
                    help="stability threshold for lane step skipping; the "
                         "mixture score here is stiffer near t=1 than the "
                         "serve workload's drift, so the demo defaults "
                         "below the engine's 0.4")
    ap.add_argument("--min-slots", type=int, default=None,
                    help="elastic capacity floor (default: fixed S = "
                         "--max-batch; min == max is bit-for-bit fixed-S)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="elastic capacity ceiling for the continuous engine")
    ap.add_argument("--resize-hysteresis", type=int, default=8,
                    help="sustained-low-occupancy rounds before a shrink")
    ap.add_argument("--use-kernels", action="store_true",
                    help="serve rounds through the fused CUDA "
                         "step+rectify(+accept) kernels (bitwise-identical "
                         "on the CPU, where they run their plain versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the continuous engine's Chrome trace-event "
                         "JSON (lifecycle spans + metrics snapshot; open in "
                         "ui.perfetto.dev, check with `python -m "
                         "repro_torch.obs`)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the Gaussian mixture")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)

    gm = GaussianMixture.random(
        torch.Generator(device=args.device).manual_seed(args.seed),
        num_modes=6, dim=args.latent[1], device=args.device)
    tgrid = uniform_tgrid(args.steps, 0.98)
    if args.sla:
        serve_sla(args, gm, tgrid)
        return
    if args.lanes:
        serve_lanes_demo(args, gm, tgrid)
        return
    reqs, arrivals = make_requests(args.requests, args.arrive_every)

    static = ChordsEngine(gm.drift, latent_shape=tuple(args.latent),
                          n_steps=args.steps, num_cores=args.cores,
                          tgrid=tgrid, max_batch=args.max_batch,
                          rtol=args.rtol,
                          use_kernel=args.use_kernels or None,
                          device=args.device)
    static_out, static_rounds = serve_static(static, reqs, arrivals)

    cont = ContinuousEngine(gm.drift, latent_shape=tuple(args.latent),
                            n_steps=args.steps, num_cores=args.cores,
                            tgrid=tgrid, num_slots=args.max_batch,
                            rtol=args.rtol, policy=args.policy,
                            min_slots=args.min_slots,
                            max_slots=args.max_slots,
                            resize_hysteresis=args.resize_hysteresis,
                            use_kernel=args.use_kernels or None,
                            tracer=Tracer() if args.trace_out else None,
                            device=args.device)
    cont_out, cont_rounds = serve_continuous(cont, reqs, arrivals)
    if args.trace_out:
        doc = cont.write_trace(args.trace_out,
                               meta={"launcher": "serve_diffusion"})
        print(f"[serve] trace: {args.trace_out} "
              f"({doc['otherData']['events']} events)")

    for rid, out in sorted(cont_out.items()):
        print(f"[serve] request {rid:>3}: core {out.accepted_core} after "
              f"{out.rounds_used}/{args.steps} rounds "
              f"({out.speedup:.2f}x, latency {out.latency_rounds} rounds)")

    # per-request outputs are scheduling-invariant
    worst = 0.0
    for rid in static_out:
        a = _np(static_out[rid].sample)
        b = _np(cont_out[rid].sample)
        worst = max(worst, float(np.abs(a - b).max()))
        assert static_out[rid].rounds_used == cont_out[rid].rounds_used, rid
    assert worst < 1e-5, f"outputs diverged across engines: {worst}"
    print(f"\n[serve] outputs identical across engines "
          f"(max |static - continuous| = {worst:.2e})")

    st = cont.stats()
    print(f"[serve] kernel path: {st['kernel_path']}")
    print(f"[serve] static batching : {static_rounds} rounds to drain "
          f"{args.requests} requests")
    print(f"[serve] continuous      : {cont_rounds} rounds to drain "
          f"(throughput {st['throughput_req_per_round']:.3f} req/round, "
          f"occupancy {st['occupancy']:.2f}, latency p50/p95 = "
          f"{st['latency_rounds_p50']:.0f}/{st['latency_rounds_p95']:.0f} rounds, "
          f"mean speedup {st['mean_speedup']:.2f}x; paper: 2.9x @ 8 cores)")
    if st["min_slots"] != st["max_slots"]:
        print(f"[serve] elastic capacity: S in "
              f"{st['min_slots']}..{st['max_slots']} (now {st['num_slots']}), "
              f"{st['grows']} grows / {st['shrinks']} shrinks, "
              f"{st['migrations']} lane migrations, "
              f"{st['wasted_slot_rounds']} wasted slot-rounds, "
              f"{st['retraces']} retraces for buckets {st['buckets_visited']}")
    if cont_rounds < static_rounds:
        print(f"[serve] continuous batching wins by "
              f"{static_rounds - cont_rounds} rounds "
              f"({static_rounds / cont_rounds:.2f}x fewer)")


if __name__ == "__main__":
    main()
