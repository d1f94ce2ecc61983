"""End-to-end training script of the PyTorch/CUDA port (the counterpart of
``examples/train_denoiser.py``): train the reduced ``chords-dit-xl``
denoiser (rectified flow) on a Gaussian mixture with AdamW, checkpointing
every 100 steps, then sample it with CHORDS against the sequential solver
and report the speedup and the latent RMSE.

The data, the weights and the noise come from seeds: nothing is
downloaded. The loss runs the plain ops (``use_kernels=False``, the
config's default), as the JAX package trains: the kernels have no
backward.

  PYTHONPATH=src python examples/torch_train_denoiser.py --steps 300
  PYTHONPATH=src python examples/torch_train_denoiser.py --steps 20 --device cpu
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import (GaussianMixture, chords_sample, make_sequence,
                              sequential_sample, uniform_tgrid)
from repro_torch.device import resolve_device
from repro_torch.diffusion import diffusion_loss, init_wrapper, make_drift
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.optim import AdamWConfig, apply_updates, init_state
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--latent-dim", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--cores", type=int, default=8)
    ap.add_argument("--sample-steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def trainable(params):
    """A parameter tree (a ParamTree or nested dict) as a nested dict of
    leaf tensors that require grad."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def train(args, dev, log=print):
    """Train the reduced denoiser; returns (params, optimizer state, cfg,
    gm, losses, checkpoint manager)."""
    cfg = get_config("chords-dit-xl", reduced=True)
    gm = GaussianMixture.random(torch.Generator(device=dev).manual_seed(7),
                                num_modes=4, dim=args.latent_dim, device=dev)
    params = trainable(init_wrapper(
        cfg, args.latent_dim, torch.Generator(device=dev).manual_seed(0),
        device=dev))
    leaves, treedef = tree_flatten(params)
    log(f"[train] denoiser params: "
        f"{sum(x.numel() for x in leaves) / 1e6:.2f}M on {dev}")

    opt = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                      weight_decay=0.0)
    state = init_state(params, opt)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "chords_denoiser_ckpt_torch")
    ckpt = CheckpointManager(ckpt_dir, keep=2)

    gen = torch.Generator(device=dev).manual_seed(1)
    losses = []
    for i in range(args.steps):
        x1 = gm.sample_data(gen, args.batch * args.seq).reshape(
            args.batch, args.seq, args.latent_dim)
        loss = diffusion_loss(params, cfg, x1, gen)
        # unused leaves (the backbone's token embedding) get zeros, as
        # jax.grad gives them
        grads = tree_unflatten(treedef, list(torch.autograd.grad(
            loss, tree_flatten(params)[0], allow_unused=True,
            materialize_grads=True)))
        with torch.no_grad():
            params, state, _ = apply_updates(params, grads, state, opt)
        params = trainable(params)
        losses.append(float(loss.detach()))
        if i % 50 == 0 or i == args.steps - 1:
            log(f"[train] step {i:>4} loss {losses[-1]:.4f}")
        if (i + 1) % 100 == 0:
            ckpt.save({"params": params, "opt": state}, i + 1)
    ckpt.save({"params": params, "opt": state}, args.steps)
    log(f"[train] checkpoints in {ckpt_dir}")
    return params, state, cfg, gm, losses, ckpt


def sample(params, cfg, args, dev, log=print):
    """CHORDS at K = --cores against the sequential solve at N =
    --sample-steps; returns (speedup, rmse, relative rmse)."""
    tg = uniform_tgrid(args.sample_steps, 0.98, device=dev)
    x0 = torch.randn((4, args.seq, args.latent_dim),
                     generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    with torch.no_grad():
        drift = make_drift(params, cfg)
        seq = sequential_sample(drift, x0, tg, device=dev)
        res = chords_sample(drift, x0, tg,
                            make_sequence(args.cores, args.sample_steps),
                            device=dev)
    rmse = float(torch.sqrt(((res.outputs[-1] - seq) ** 2).mean()))
    scale = float(torch.sqrt((seq ** 2).mean()))
    speedup = res.speedup(args.cores - 1)
    log(f"[sample] CHORDS K={args.cores}: speedup {speedup:.2f}x, latent "
        f"RMSE {rmse:.4f} (rel {rmse / scale:.3%}) vs sequential "
        f"N={args.sample_steps}")
    return speedup, rmse, rmse / scale


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    params, _, cfg, _, _, _ = train(args, dev)
    sample(params, cfg, args, dev)


if __name__ == "__main__":
    main()
