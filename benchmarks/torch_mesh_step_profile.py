"""Device time of one train step of ``internlm2-1.8b`` at full width
(bf16, batch 4 x 512, 2 microbatches, remat) on one device and on a (1, 1)
NCCL mesh, each in a device-only profiler window after two warm steps, and
the kernels whose launches or time differ between the two.

  python benchmarks/torch_mesh_step_profile.py [--steps-warm 2]

Prints a line per path (device ms, kernels) and the differing kernels,
then one JSON object of both totals. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(step, params, state, batch, warm):
    import torch
    from torch.profiler import ProfilerActivity, profile

    box = {"p": params, "s": state}
    for _ in range(warm):
        box["p"], box["s"], _ = step(box["p"], box["s"], batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        box["p"], box["s"], _ = step(box["p"], box["s"], batch)
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps-warm", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import train_step as ts
    from repro_torch.utils import pspec

    cfg = get_config("internlm2-1.8b")
    pipe = DataPipeline(cfg, seq_len=512, global_batch=4)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=4)
    batch = ts.batch_to(pipe(0), "cuda")
    params = api.init_model(cfg, 0, device="cuda")
    one = _profile(ts.make_train_step(cfg, opt, num_microbatches=2,
                                      remat=True),
                   params, init_state(params, opt), batch, args.steps_warm)
    del params
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mesh_step_profile_")
    try:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            device_id=torch.device("cuda", 0))
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        dp = distribute_tree(api.init_model(cfg, 0, device="cuda"),
                             ShardingCtx(mesh, TRAIN_RULES),
                             pspec.logical_axes(api.model_specs(cfg)))
        on_mesh = _profile(ts.make_train_step(cfg, opt, num_microbatches=2,
                                              mesh=mesh, remat=True),
                           dp, init_state(dp, opt), batch, args.steps_warm)
        dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    totals = {}
    for name, ev in (("one_device", one), ("mesh", on_mesh)):
        totals[name] = {"device_ms": sum(t for _, t in ev.values()),
                        "kernels": sum(n for n, _ in ev.values())}
        print(name, totals[name], flush=True)
    diff = []
    for k in set(one) | set(on_mesh):
        (n1, t1), (n2, t2) = one.get(k, (0, 0.0)), on_mesh.get(k, (0, 0.0))
        if n1 != n2 or abs(t1 - t2) > 0.5:
            diff.append((t2 - t1, n1, n2, k[:100]))
    for d in sorted(diff, reverse=True)[:20]:
        print("mesh - one device: %+.4f ms, launches %d -> %d, %s" % d)
    print(json.dumps(totals))


if __name__ == "__main__":
    main()
