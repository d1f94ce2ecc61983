"""Tables from the production-mesh dry runs, and the dry run's cell of the
LM trainer's one-device step.

  python benchmarks/torch_dryrun_report.py cells [--out results/dryrun_torch]
      one line per cell JSON of ``python -m repro_torch.launch.dryrun``:
      built or skipped, the trace's wall seconds, per-rank FLOPs, eager
      bytes, least bytes (arguments + outputs), collective bytes, eager
      peak, and the roofline's lower bound with the term that sets it,
      ``A..B`` where the term at the eager bytes is another
      (``hlo_analysis.roofline_terms``, recomputed from the counts)
  python benchmarks/torch_dryrun_report.py census ARCH \\
      [--out results/dryrun_torch] [--ref results/dryrun]
      the port's collective census of ARCH's cells by (op, mesh axis,
      dtype), beside the reference's ``collective_bytes`` of the same cells
      (``python -m repro.launch.dryrun``, whose JSON this reads; it does not
      import the reference)
  python benchmarks/torch_dryrun_report.py lm-train
      builds the one-device cell of ``internlm2-1.8b``'s train step at
      batch 4 x 512, 2 microbatches, remat (the chip phase [lm-train]'s
      step) on a fake (1, 1) mesh on the CPU, and prints its FLOPs and
      eager bytes beside the step's bound at the card's figures

Every number is per rank; nothing here runs on a card.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _load(pattern):
    out = {}
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            out[os.path.basename(path)[:-5]] = json.load(f)
    return out


def cells(out_dir):
    from repro_torch.launch import hlo_analysis as H

    for name, r in _load(os.path.join(out_dir, "*.json")).items():
        if r.get("skipped"):
            print(f"{name}\tskipped\t{r['reason']}")
            continue
        pd, ma = r["per_device"], r["memory_analysis"]
        least = ma["argument_size_in_bytes"] + ma["output_size_in_bytes"]
        t = H.roofline_terms(pd["flops"], pd["hbm_bytes"],
                             pd["collective_bytes"]["total"], least)
        dom = t["bottleneck"] if t["bottleneck"] == t["bottleneck_eager"] \
            else f"{t['bottleneck']}..{t['bottleneck_eager']}"
        print(f"{name}\tbuilt\t{r['compile_wall_s']:.1f} s\t"
              f"flops {pd['flops']:.4g}\tbytes {pd['hbm_bytes']:.4g}\t"
              f"least {least:.4g}\t"
              f"coll {pd['collective_bytes']['total']:.4g}\t"
              f"peak {ma['eager_peak_bytes']:.4g}\t"
              f"{dom} >= {t['bound_s']:.4g} s")


def census(arch, out_dir, ref_dir):
    port = _load(os.path.join(out_dir, f"{arch}__*__pod.json"))
    ref = _load(os.path.join(ref_dir, f"{arch}__*__pod.json"))
    for name in sorted(set(port) | set(ref)):
        print(f"== {name}")
        p = port.get(name, {})
        if p.get("skipped") or not p:
            print("  port: " + ("skipped" if p else "no record"))
        else:
            cb = p["per_device"]["collective_bytes"]
            print(f"  port total {cb['total']:.6g} B in {cb['num_ops']} "
                  f"launches")
            for e in cb["by_axis"]:
                print(f"    {e['op']:<18} {e['axis']:<6} {e['dtype']:<9} "
                      f"{e['launches']:>6} launches {e['bytes']:.6g} B")
        r = ref.get(name, {})
        if r and not r.get("skipped"):
            cb = r["per_device"]["collective_bytes"]
            print(f"  reference total {cb['total']:.6g} B in "
                  f"{cb['num_ops']} ops: " + ", ".join(
                      f"{k} {cb[k]:.6g}" for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all", "collective-permute")))
        else:
            print("  reference: " + ("skipped" if r else "no record"))


def lm_train():
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api as model_api

    D.init_fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    cfg = get_config("internlm2-1.8b")
    shape = ShapeConfig("lm_train_4x512", 512, 4, "train")
    r = D.build_lm_cell(cfg, shape, mesh, microbatches=2)
    n = float(model_api.param_count(cfg))
    toks = shape.global_batch * shape.seq_len
    out = {
        "cell": "internlm2-1.8b train, batch 4 x 512, 2 microbatches, "
                "remat, (1, 1)",
        "flops": r["per_device"]["flops"],
        "flops_ms": r["per_device"]["flops"] / H.PEAK_FLOPS * 1e3,
        "model_flops_6nt": 6.0 * n * toks,
        "model_flops_remat_8nt": 8.0 * n * toks,
        "eager_bytes": r["per_device"]["hbm_bytes"],
        "eager_bytes_ms": r["per_device"]["hbm_bytes"] / H.HBM_BW * 1e3,
        "argument_bytes": r["memory_analysis"]["argument_size_in_bytes"],
        "eager_peak_bytes": r["memory_analysis"]["eager_peak_bytes"],
        "traced_ops": r["per_device"]["traced_ops"],
        "flops_by_op": r["per_device"]["flops_by_op"],
        "trace_wall_s": r["trace_wall_s"],
        "card": H.CARD,
    }
    print(json.dumps(out, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("cells", "census", "lm-train"))
    ap.add_argument("arch", nargs="?")
    ap.add_argument("--out", default=os.path.join(ROOT,
                                                  "results/dryrun_torch"))
    ap.add_argument("--ref", default=os.path.join(ROOT, "results/dryrun"))
    args = ap.parse_args(argv)
    if args.what == "cells":
        cells(args.out)
    elif args.what == "census":
        if not args.arch:
            ap.error("census needs ARCH")
        census(args.arch, args.out, args.ref)
    else:
        lm_train()


if __name__ == "__main__":
    main()
