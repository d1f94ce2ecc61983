"""LM path of the PyTorch/CUDA port, as ``examples/lm_generate.py``:
train a reduced LM briefly (``train_loop`` on the synthetic data
pipeline), then greedy-decode with prefill and the KV cache (or xLSTM's
recurrent state), for every LM config the reference serves.

  PYTHONPATH=src python examples/torch_lm_generate.py --arch internlm2-1.8b
  PYTHONPATH=src python examples/torch_lm_generate.py --device cpu
  PYTHONPATH=src python examples/torch_lm_generate.py \
      --arch seamless-m4t-medium --device cpu --train-steps 5

The reduced config with random weights from seed 0, ``--train-steps``
AdamW steps on ``DataPipeline(seq_len=32, global_batch=8)`` (no remat),
then, as in the reference, a [2, 8] prompt from the pipeline's step 999;
enc-dec prefills from zero source frames [2, 4, D] and decodes step by
step.
"""
import argparse
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim import AdamWConfig
from repro_torch.serve import greedy_generate, make_decode_step, make_prefill
from repro_torch.train import TrainLoopConfig, train_loop

BATCH, PROMPT_LEN, SRC_LEN, SEED = 2, 8, 4, 0


def generate_encdec(cfg, params, prompt, steps: int, max_len: int):
    """Enc-dec greedy tokens [B, S0 + steps] from zero source frames."""
    src = torch.zeros((prompt.shape[0], SRC_LEN, cfg.d_model),
                      dtype=getattr(torch, cfg.compute_dtype),
                      device=prompt.device)
    with torch.no_grad():
        logits, cache = make_prefill(cfg, max_len)(params, prompt, src)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks = [prompt.to(torch.int32), tok]
        decode = make_decode_step(cfg)
        for _ in range(steps - 1):
            logits, cache = decode(params, tok, cache)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            toks.append(tok)
    return torch.cat(toks, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--gen-steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, reduced=True)
    print(f"[gen] {cfg.name}: {api.param_count(cfg) / 1e6:.1f} M parameters "
          f"on {dev}, random from seed {SEED}")
    params = api.init_model(cfg, SEED, device=dev)
    pipe = DataPipeline(cfg, seq_len=32, global_batch=8)
    opt = AdamWConfig(lr=1e-3, total_steps=args.train_steps, warmup_steps=5)
    params, _, _ = train_loop(
        cfg, params, pipe, opt,
        TrainLoopConfig(total_steps=args.train_steps, log_every=10),
        remat=False)
    prompt = torch.from_numpy(pipe(999)["tokens"][:BATCH, :PROMPT_LEN]).to(
        dev)
    t0 = time.perf_counter()
    if api.is_encdec(cfg):
        print(f"[gen] {args.arch} is enc-dec; decoding with zero source "
              f"memory")
        out = generate_encdec(cfg, params, prompt, args.gen_steps,
                              PROMPT_LEN + args.gen_steps)
    else:
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
