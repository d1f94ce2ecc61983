"""Quickstart of the PyTorch/CUDA port: accelerate sampling of an exact
multimodal diffusion ODE with CHORDS and compare against the sequential
solver (the counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py            # on the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.core import (GaussianMixture, chords_sample, make_sequence,
                              select_output, sequential_sample, uniform_tgrid)
from repro_torch.device import resolve_device

N_STEPS = 50
NUM_CORES = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # a diffusion model with a closed-form velocity field (no training needed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    gm = GaussianMixture.random(gen, num_modes=6, dim=16, device=dev)
    x0 = torch.randn((4, 16), generator=gen, device=dev)  # t=0 noise
    tgrid = uniform_tgrid(N_STEPS, t_max=0.98, device=dev)

    with torch.no_grad():
        # golden sequential solve (50 network calls)
        seq = sequential_sample(gm.drift, x0, tgrid, device=dev)
        # CHORDS: hierarchical multi-core solve (paper Algorithm 1)
        i_seq = make_sequence(NUM_CORES, N_STEPS)
        res = chords_sample(gm.drift, x0, tgrid, i_seq, device=dev)

    print(f"device             : {dev} "
          f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")
    print(f"init sequence      : {i_seq}")
    for k in range(NUM_CORES):
        rmse = float(torch.sqrt(((res.outputs[k] - seq) ** 2).mean()))
        print(f"core {k}: arrives at round {res.emit_rounds[k]:>2} "
              f"(speedup {res.speedup(k):.2f}x)  latent RMSE vs sequential "
              f"{rmse:.5f}")

    core, rounds, speedup = select_output(res, rtol=0.05)
    print(f"\nstreaming early-exit accepts core {core} after {rounds} rounds "
          f"=> {speedup:.2f}x speedup (paper reports 2.9x at 8 cores)")
    return res, seq


if __name__ == "__main__":
    main()
