"""Production-mesh dry run: build and measure every (architecture x shape
x mesh) cell on a fake process group — port of ``repro.launch.dryrun``.

For each cell: lay the cell's parameters, optimizer state, batch and cache
out on the production mesh (``launch/mesh.py``: (16, 16) ``(data, model)``
or (2, 16, 16) ``(pod, data, model)``) as fake DTensors under the port's
rule tables, run the port's own step on them as rank 0 (the train step,
a prefill, a decode step, or one CHORDS slot-grid round), and record what
``launch/hlo_analysis.py`` read from the run: per-rank FLOPs, an eager
byte bound, the collective census, live bytes and the roofline terms at
the card's figures, to ``results/dryrun_torch/<cell>.json``.

The reference forces 512 placeholder host devices and compiles; here a
fake process group of 256 or 512 ranks (``torch.distributed``'s ``fake``
backend) stands in for them, and every tensor is a fake tensor: nothing is
allocated and no collective moves data. The group is made only in this
module's own process (:func:`init_fake_world`, called by :func:`main`).
The trace takes the plain path (``use_kernels`` is False by default), as
the reference lowers its plain ops: the dry run launches no kernel.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch chords-dit-xl --shape chords_image
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--timeout 2400]
  (``--device cpu`` on a host without a card: the mesh and the fake tensors
  are then CPU ones; the default ``cuda`` refuses such a host)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, ShapeConfig,
                                 get_config, shape_applicable)
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (SERVE_DEEP_TP_RULES, SERVE_RULES,
                                       TRAIN_LAYERS_FSDP_RULES, TRAIN_RULES,
                                       ShardingCtx, mesh_sizes,
                                       use_sharding)
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import dp_size, make_production_mesh
from repro_torch.models import api as model_api

# paper-native CHORDS denoiser cells: one lockstep round of the
# continuous-batching slot grid (repro_torch.serve.ContinuousEngine's body)
CHORDS_SHAPES = {
    # (num_slots, num_cores, batch_per_slot, latent_seq, latent_dim)
    "chords_image": (16, 8, 8, 4096, 64),   # Flux-class 2k image latents
    "chords_video": (16, 8, 1, 32768, 64),  # Hunyuan-class 720p video latents
}
CHORDS_STEPS = 50

DEFAULT_MICROBATCH = {"train_4k": 8}

ALL_CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in
             ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("chords-dit-xl", "chords_image"), ("chords-dit-xl", "chords_video")]


def init_fake_world(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is already up; the dry run needs "
                               f"{world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _pad_heads(cfg, tp=16):
    """Pad q/kv head counts up to a multiple of the TP degree (padded wo rows
    are zero in real deployments, so outputs are unchanged). Keeps attention
    head-sharded instead of falling back to head_dim-sharding, whose sharded
    QK^T contraction all-reduces the score tensor every chunk."""
    up = lambda x: -(-x // tp) * tp  # noqa: E731
    return cfg.replace(num_heads=up(cfg.num_heads),
                       num_kv_heads=up(cfg.num_kv_heads))


def cell_rules(kind: str, variant: str = ""):
    """The rule table of a cell: ``TRAIN_RULES`` for a train cell,
    ``SERVE_RULES`` else; ``fsdplayers`` (train) and ``deeptp`` (decode)
    swap in their tables, as the reference's ``build_cell``."""
    if kind == "train":
        return TRAIN_LAYERS_FSDP_RULES if "fsdplayers" in variant \
            else TRAIN_RULES
    if kind == "decode" and "deeptp" in variant:
        return SERVE_DEEP_TP_RULES
    return SERVE_RULES


# --- fake tensors laid out on the mesh ---------------------------------------

def _map(fn, structs, axes, path=()):
    if isinstance(structs, S.TensorStruct):
        return fn(structs, axes, path)
    return {k: _map(fn, structs[k], axes[k], path + (k,)) for k in structs}


def fake_tree(structs, axes, ctx: ShardingCtx, device, host=()):
    """Fake DTensors for a tree of structs, each laid out by its logical
    axes under ``ctx`` (its local block a fake tensor on ``device``; call
    inside the fake mode). Leaves named in ``host`` stay plain fake
    tensors, whole on every rank."""
    from torch.distributed.tensor import DTensor

    sizes = tuple(int(s) for s in ctx.mesh.shape)

    def one(st, ax, path):
        if path and path[-1] in host:
            return torch.empty(st.shape, dtype=st.dtype, device=device)
        pl = ctx.placements(ax, st.shape)
        local = torch.empty(H.spec_local_shape(st.shape, pl, sizes),
                            dtype=st.dtype, device=device)
        stride = tuple(math.prod(st.shape[i + 1:])
                       for i in range(len(st.shape)))
        return DTensor.from_local(local, ctx.mesh, pl, run_check=False,
                                  shape=tuple(st.shape), stride=stride)

    return _map(one, structs, axes)


def _chords_structs(cfg: ModelConfig, dims):
    """(wrapper param structs in bf16, their axes, carry structs, carry
    axes) of a CHORDS slot-grid cell of ``dims`` (S, K, B, seq, ld)."""
    from repro_torch.diffusion.wrapper import wrapper_specs
    from repro_torch.utils import pspec

    s_, k, b, seq, ld = dims
    wspecs = wrapper_specs(cfg, ld)
    ps = S.param_structs(wspecs, torch.bfloat16)
    lat = S.TensorStruct((s_, k, b, seq, ld), torch.float32)
    lat_ax = ("slots", "cores", "batch", "seq", None)
    carry = {"x": lat, "x_snap": lat, "f_snap": lat,
             "p": S.TensorStruct((s_, k), torch.int32), "finals": lat}
    carry_ax = {"x": lat_ax, "x_snap": lat_ax, "f_snap": lat_ax,
                "p": ("slots", "cores"), "finals": lat_ax}
    return ps, pspec.logical_axes(wspecs), carry, carry_ax


def lm_state(cfg: ModelConfig, shape: ShapeConfig, ctx: ShardingCtx,
             device, variant: str = "") -> dict:
    """The fake DTensors of an LM cell's state on ``ctx``'s mesh, as the
    cell runs with them (call inside the cell's fake mode): ``params``; a
    train cell's ``opt`` (``compressed``: with its error-feedback state,
    ``grad_shards`` = the data ranks); a decode cell's ``cache``, whose
    ``len`` is a plain fake tensor."""
    from repro_torch.optim.optimizer import AdamWConfig

    out = {"params": fake_tree(*S.model_structs(cfg), ctx, device)}
    if shape.kind == "train":
        wire = "compressed" in variant
        out["opt"] = fake_tree(*S.opt_structs(
            cfg, AdamWConfig(compress_grads=wire),
            mesh_sizes(ctx.mesh)["data"] if wire else 1), ctx, device)
    if shape.kind == "decode":
        out["cache"] = fake_tree(*S.cache_structs(cfg, shape), ctx, device,
                                 host=("len",))
    return out


def chords_state(cfg: ModelConfig, dims, ctx: ShardingCtx, device) -> dict:
    """The fake DTensors of a CHORDS slot-grid cell of ``dims`` (S, K, B,
    seq, ld): the wrapper's ``params`` and the round's ``carry`` leaves."""
    ps, pax, carry, cax = _chords_structs(cfg, dims)
    return {"params": fake_tree(ps, pax, ctx, device),
            "carry": fake_tree(carry, cax, ctx, device)}


def _device_bytes(cache: dict) -> int:
    """A cache's bytes on this rank's device (``len`` is on the host)."""
    return H.local_bytes({k: v for k, v in cache.items() if k != "len"})


def state_bytes(state: dict) -> dict:
    """Per-rank bytes of each part of a cell's state (a cache's ``len``
    left out: the port keeps it on the host)."""
    return {k: _device_bytes(v) if k == "cache" else H.local_bytes(v)
            for k, v in state.items()}


# --- building and running a cell ---------------------------------------------

class CellTrace:
    """A cell's run: the fake mode, the counter and the wire counter."""

    def __init__(self, mesh):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.mesh = mesh
        self.fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        self.counter = H.TraceCounter(mesh)
        self.wire = {}
        self.args_bytes = 0
        self.out_bytes = 0
        self.wall_s = 0.0

    @contextlib.contextmanager
    def run(self, args):
        """Count everything run inside (``args`` live throughout)."""
        from repro_torch.dist import collectives as coll

        coll.reset_wire_bytes()
        self.args_bytes = H.local_bytes(args)
        t0 = time.time()
        with self.fake_mode:
            self.counter.track(args)
            with self.counter:
                yield
        self.wall_s = time.time() - t0
        self.wire = {k: list(v) for k, v in coll.WIRE_GROUPS.items()}


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int, variant: str = "", device: str = "cuda"):
    """Build and run one cell of ``ALL_CELLS`` (plus ``variant`` tags) on
    the production mesh over the fake process group (made by the caller:
    :func:`init_fake_world`); returns its record (:func:`_analyze`)."""
    cfg = cfg_flops = get_config(arch)
    if "padheads" in variant:
        cfg = _pad_heads(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    if shape_name in CHORDS_SHAPES:
        return build_chords_cell(cfg, shape_name, mesh, cfg_flops=cfg_flops)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"skipped": True, "reason": why}
    return build_lm_cell(cfg, shape, mesh, microbatches, variant,
                         cfg_flops=cfg_flops)


def build_lm_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  microbatches: int = 1, variant: str = "", cfg_flops=None):
    """A train, prefill or decode cell of ``cfg`` at ``shape`` on ``mesh``
    (any ``DeviceMesh`` over the fake group, ``(data, model)`` or
    ``(pod, data, model)``)."""
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.serve.steps import make_decode_step, make_prefill
    from repro_torch.train.train_step import make_train_step

    cfg_flops = cfg_flops or cfg
    device = mesh.device_type
    rules = cell_rules(shape.kind, variant)
    ctx = ShardingCtx(mesh, rules)
    tr = CellTrace(mesh)
    b_structs = S.batch_specs(cfg, shape)
    b_axes = S.batch_axes(cfg, shape)

    fw = {"attn_impl": "chunked_bf16p" if "bf16p" in variant else "chunked"}
    if cfg.family == "moe":
        fw["num_groups"] = dp_size(mesh)
    if cfg.family == "ssm":
        fw = {}

    with tr.fake_mode:
        state = lm_state(cfg, shape, ctx, device, variant)
    params = state["params"]

    if shape.kind == "train":
        # 'compressed': the gradient reduction over data as the int8
        # error-feedback wire collective
        wire = "compressed" in variant
        opt = state["opt"]
        fn = make_train_step(cfg, AdamWConfig(compress_grads=wire),
                             num_microbatches=1 if wire else microbatches,
                             mesh=mesh if wire else None,
                             **{**fw, "remat": True})
        with tr.fake_mode:
            # every rank holds the global batch; the step keeps its rows
            batch = {k: torch.empty(st.shape, dtype=st.dtype, device=device)
                     for k, st in b_structs.items()}
            laid = fake_tree(b_structs, b_axes, ctx, device)
        with use_sharding(mesh, rules), tr.run((params, opt, laid)):
            new_p, new_o, metrics = fn(params, opt, batch)
        tr.out_bytes = H.local_bytes((new_p, new_o, metrics))
        return _analyze(cfg_flops, shape, mesh, tr, kind="train",
                        extra={"bytes": state_bytes(state)})

    with tr.fake_mode:
        batch = fake_tree(b_structs, b_axes, ctx, device)

    if shape.kind == "prefill":
        fn = make_prefill(cfg, shape.seq_len, **fw)
        args = [params, batch["tokens"]]
        if model_api.is_encdec(cfg):
            args.append(batch["src_embeds"])
        with use_sharding(mesh, rules), tr.run(args):
            logits, cache = fn(*args)
        tr.out_bytes = H.local_bytes((logits, cache))
        return _analyze(cfg_flops, shape, mesh, tr, kind="prefill",
                        extra={"bytes": {**state_bytes(state),
                                         "cache_out": _device_bytes(cache)}})

    # decode: the cache is full to seq_len - 1 and the step writes its last
    # position, so the attention reads the whole cache, as the reference's
    # full-length mask does. The port keeps ``len`` on the host (a decode
    # step reads it there), so it is a real tensor here.
    cache = state["cache"]
    if "len" in cache:
        cache["len"] = torch.full(cache["len"].shape, shape.seq_len - 1,
                                  dtype=cache["len"].dtype)
    fw.pop("attn_impl", None)
    fn = make_decode_step(cfg, **fw)
    held = state_bytes(state)
    with use_sharding(mesh, rules), tr.run((params, batch, cache)):
        logits, cache = fn(params, batch["tokens"], cache)
    tr.out_bytes = H.local_bytes(logits)  # the cache is updated in place
    return _analyze(cfg_flops, shape, mesh, tr, kind="decode",
                    extra={"bytes": held,
                           "decode_position": shape.seq_len - 1})


def build_chords_cell(cfg: ModelConfig, shape_name: str, mesh,
                      cfg_flops=None, dims=None, n_steps: int = CHORDS_STEPS):
    """One lockstep round of the continuous-batching slot grid on the
    mesh: the serve runtime's hot loop.

    Slots ride the 'data' axis (each data rank owns S/data request lanes,
    cores local to the rank so the inter-core roll needs no wire); each
    drift eval is TP over 'model'. The round runs under ``use_sharding``
    with ``SERVE_RULES``; afterwards the carry latents that entered and
    left the round must have the local shape [S/data, K, B, seq, ld] (the
    slot-shard check), else it raises. ``dims`` (S, K, B, seq, ld)
    overrides ``CHORDS_SHAPES[shape_name]``."""
    from repro_torch.core.chords import ChordsCarry, make_slot_round_body
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion.wrapper import make_drift

    cfg_flops = cfg_flops or cfg
    dims = tuple(dims or CHORDS_SHAPES[shape_name])
    s_, k, b, seq, ld = dims
    device = mesh.device_type
    rules = dict(SERVE_RULES)
    ctx = ShardingCtx(mesh, rules)
    tr = CellTrace(mesh)
    tg_real = uniform_tgrid(n_steps)
    sk = {"i_arr": S.TensorStruct((s_, k), torch.int32),
          "r": S.TensorStruct((s_,), torch.int32),
          "live": S.TensorStruct((s_,), torch.bool)}
    sk_ax = {"i_arr": ("slots", "cores"), "r": ("slots",),
             "live": ("slots",)}
    with tr.fake_mode:
        state = chords_state(cfg, dims, ctx, device)
        ins = fake_tree(sk, sk_ax, ctx, device)
        tgrid = tr.fake_mode.from_tensor(tg_real).to(device)

    params, carry = state["params"], ChordsCarry(**state["carry"])
    body = make_slot_round_body(make_drift(params, cfg), tgrid, n_steps, k)
    with use_sharding(mesh, rules), tr.run((params, carry, ins)):
        new_carry, _ = body(carry, ins["i_arr"], ins["r"], ins["live"])
    tr.out_bytes = H.local_bytes(new_carry)

    # the slot-shard check: the carry latents enter and leave the round
    # with the slot axis divided by the 'data' mesh size
    want = [s_ // mesh_sizes(mesh)["data"], k, b, seq, ld]
    check_slot_shards({"entered": carry._asdict(),
                       "left": new_carry._asdict()}, want)

    fake_shape = ShapeConfig(shape_name, seq, s_ * k * b, "chords")
    return _analyze(cfg_flops, fake_shape, mesh, tr, kind="chords",
                    extra={"num_slots": s_, "num_cores": k,
                           "latent_dim": ld,
                           "slot_shard_check": {"global": list(dims),
                                                "per_device": want},
                           "bytes": state_bytes(state)})


def check_slot_shards(trees: dict, want) -> None:
    """Raise unless every latent (a leaf of ``want``'s rank) of each tree
    in ``trees`` ({where: tree}) has the local shape ``want``."""
    for where, tree in trees.items():
        lats = [d for _, d in H.find_param_shape(tree, want)]
        if not lats or any(d != list(want) for d in lats):
            raise RuntimeError(
                f"slot grid not sharded as intended: wanted per-device "
                f"{list(want)}, the carry latents {where} the round with "
                f"{lats[:6]}")


def _n_eff_params(cfg: ModelConfig) -> float:
    """FLOP-relevant params: active experts only; embedding lookup excluded."""
    total = model_api.param_count(cfg)
    if cfg.family == "moe":
        total -= cfg.num_layers * (cfg.num_experts - cfg.experts_per_tok) \
            * 3 * cfg.d_model * cfg.d_ff
    if not cfg.tie_embeddings:
        total -= cfg.vocab_size * cfg.d_model  # lookup table (unembed stays)
    return float(total)


def _model_flops(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> float:
    n = _n_eff_params(cfg)
    toks = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    if kind == "train":
        return 6.0 * n * toks
    return 2.0 * n * toks  # prefill, decode; chords: one drift eval a core


def _analyze(cfg, shape, mesh, tr: CellTrace, kind: str, extra=None) -> dict:
    """A cell's record, under the reference's keys. Where the port's value
    means something else:

    * ``per_device.flops``: the matmul-like ops' FLOPs on this rank's
      local shards, counted as the step ran (no loop weighting is needed:
      an eager run executes every trip);
    * ``per_device.hbm_bytes``: every local op's input and output bytes,
      an eager, unfused upper bound, not XLA's fused estimate;
    * ``per_device.collective_bytes``: the census of both routes
      (``hlo_analysis.collective_bytes``), ``by_axis`` by (op, mesh axis,
      dtype);
    * ``per_device.traced_ops``: the local ops run (the reference's
      ``hlo_bytes``, the HLO's size, has no counterpart);
    * ``memory_analysis``: argument and output bytes of this rank from the
      local shapes (the train step writes into its arguments, so its
      outputs alias them), and ``eager_peak_bytes``, the peak of live
      storage bytes during the run, arguments included
      (``eager_temp_bytes`` = peak - arguments), not XLA's temp size;
    * ``roofline``: at the H100's figures (``hlo_analysis.CARD``), the
      memory term twice: at the eager bytes and at the least bytes (the
      arguments read and the outputs written once); ``bottleneck`` is the
      term of the largest lower bound, ``bottleneck_eager`` the largest
      term at the eager bytes (``hlo_analysis.roofline_terms``);
    * ``compile_wall_s`` (set by :func:`main`): the seconds to build and
      run the cell on fake tensors; there is no compile.
    """
    chips = math.prod(int(s) for s in mesh.shape)
    tc = tr.counter
    coll = H.collective_bytes(tc.collectives,
                              H.wire_census(tr.wire, H.group_axes(mesh)))
    flops_w, bytes_w = tc.flops, tc.bytes
    terms = H.roofline_terms(flops_w, bytes_w, coll["total"],
                             tr.args_bytes + tr.out_bytes)
    mf = _model_flops(cfg, shape, kind)
    out = {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": kind,
        "mesh": [int(s) for s in mesh.shape],
        "axes": list(mesh.mesh_dim_names),
        "chips": chips,
        "per_device": {"flops": flops_w, "hbm_bytes": bytes_w,
                       "flops_by_op": dict(tc.flops_by_op),
                       "traced_ops": tc.ops,
                       "collective_bytes": coll},
        "global_flops": flops_w * chips,
        "model_flops": mf,
        "n_params": float(model_api.param_count(cfg)),
        "useful_flops_ratio": mf / max(1.0, flops_w * chips),
        "roofline": terms,
        "memory_analysis": {
            "argument_size_in_bytes": tr.args_bytes,
            "output_size_in_bytes": tr.out_bytes,
            "eager_peak_bytes": tc.peak_live_bytes,
            "eager_temp_bytes": tc.peak_live_bytes - tr.args_bytes},
        "trace_wall_s": tr.wall_s,
    }
    if extra:
        out.update(extra)
    return out


def _cell_name(arch, shape, multi_pod, tag=""):
    return f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}{tag}"


def _run_all(args) -> int:
    """Every cell of ``ALL_CELLS`` in a subprocess of its own, pod and
    multi-pod (multi-pod only with ``--multi-pod``), as many at a time as
    half the host's cores; a cell whose JSON is already in ``--out`` is
    skipped."""
    from concurrent.futures import ThreadPoolExecutor

    todo = []
    for arch, shape in ALL_CELLS:
        for mp in ([False, True] if not args.multi_pod else [True]):
            name = _cell_name(arch, shape, mp, args.tag)
            if os.path.exists(os.path.join(args.out, name + ".json")):
                print(f"[dryrun] cached {name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", args.out,
                   "--device", args.device]
            if args.tag:
                cmd += ["--tag", args.tag]
            if mp:
                cmd.append("--multi-pod")
            todo.append((name, cmd))

    def one(job):
        name, cmd = job
        print(f"[dryrun] {name} ...", flush=True)
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(f"[dryrun] TIMEOUT {name} ({args.timeout}s)", flush=True)
            return name
        if r.returncode != 0:
            print(f"[dryrun] FAIL {name} ({time.time() - t0:.0f}s)\n"
                  f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}", flush=True)
            return name
        print(f"[dryrun] ok {name} ({time.time() - t0:.0f}s)", flush=True)
        return None

    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) // 2)) as pool:
        failures = [n for n in pool.map(one, todo) if n]
    print(f"[dryrun] done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's and the fake tensors' device")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    if args.all:
        sys.exit(_run_all(args))

    if not args.arch or not args.shape:
        ap.error("--arch and --shape (or --all)")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        print(f"[dryrun] a fake CUDA mesh cannot be built here: "
              f"torch.cuda.is_available() is False (torch "
              f"{torch.__version__}); pass --device cpu", file=sys.stderr)
        sys.exit(2)
    mb = args.microbatches or DEFAULT_MICROBATCH.get(args.shape, 1)
    init_fake_world(512 if args.multi_pod else 256)
    t0 = time.time()
    res = build_cell(args.arch, args.shape, args.multi_pod, mb,
                     variant=args.tag, device=args.device)
    res["compile_wall_s"] = time.time() - t0
    res["microbatches"] = mb
    name = _cell_name(args.arch, args.shape, args.multi_pod, args.tag)
    path = os.path.join(args.out, name + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    if res.get("skipped"):
        print(f"[dryrun] SKIP {name}: {res['reason']}")
        return
    print(f"[dryrun] {name}: traced {res['compile_wall_s']:.0f}s")
    print("  memory_analysis:", res["memory_analysis"])
    print("  per rank: flops=%.3e bytes (eager bound)=%.3e ops=%d" % (
        res["per_device"]["flops"], res["per_device"]["hbm_bytes"],
        res["per_device"]["traced_ops"]))
    print("  collectives/rank: %.3e B (%d ops)" % (
        res["per_device"]["collective_bytes"]["total"],
        res["per_device"]["collective_bytes"]["num_ops"]))
    print("  roofline:", {k: (f"{v:.2e}" if isinstance(v, float) else v)
                          for k, v in res["roofline"].items()})
    print("  useful_flops_ratio: %.3f" % res["useful_flops_ratio"])


if __name__ == "__main__":
    main()
