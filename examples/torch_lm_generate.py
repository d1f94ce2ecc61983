"""LM serving path of the PyTorch/CUDA port: greedy decoding with prefill
and the KV cache (the generate half of ``examples/lm_generate.py``).

  PYTHONPATH=src python examples/torch_lm_generate.py --arch internlm2-1.8b
  PYTHONPATH=src python examples/torch_lm_generate.py --device cpu

The reduced config with random weights from seed 0 and, as in the
reference, a [2, 8] prompt; the reference example first trains the model
for a few steps, which waits for the LM trainer (ROADMAP.md queue 1 item
11).
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve import greedy_generate

ARCHS = ("qwen1.5-0.5b", "qwen1.5-32b", "gemma-7b", "internlm2-1.8b",
         "qwen2-vl-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
BATCH, PROMPT_LEN, SEED = 2, 8, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCHS)
    ap.add_argument("--gen-steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    print(f"[gen] {cfg.name}: {api.param_count(cfg) / 1e6:.1f} M parameters "
          f"on {dev}; training first (as examples/lm_generate.py does) "
          f"waits for the LM trainer, ROADMAP.md queue 1 item 11: the "
          f"weights are random from seed {SEED}")
    params = api.init_model(cfg, SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                           generator=gen, device=dev)
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, steps=args.gen_steps,
                          max_len=PROMPT_LEN + args.gen_steps)
    out = out.cpu()
    secs = time.perf_counter() - t0
    print(f"[gen] prompt shape {tuple(prompt.shape)} -> generated "
          f"{tuple(out.shape)} in {secs:.3f} s")
    print("[gen] sample token ids:", out[0, :24].tolist())
    return out


if __name__ == "__main__":
    main()
