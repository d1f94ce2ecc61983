"""The port's side of the mesh tests: programs that run on W gloo ranks of
the CPU, each rank a process of its own, and write what they computed for
the tests in ``test_torch_mesh_steps.py``, ``test_torch_mesh_launch.py``,
``test_torch_serve_mesh.py`` and ``test_torch_lm_serve_mesh.py`` to
compare with the JAX package. Imports no JAX.

    PYTHONPATH=src:tests python -m test_torch_mesh_ranks <job> <io_dir>

reads ``<io_dir>/inputs.pkl`` and writes ``<io_dir>/<job>.pkl`` (rank 0).
Ranks meet through a FileStore in ``io_dir`` (no TCP port: the suite runs
in parallel workers), run one intra-op thread each, and a rank that fails
writes its traceback to ``<io_dir>/<job>.rank<r>.err``.

The tests here hold the helpers that need no ranks.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import time
import traceback

import torch

ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b")
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-4)
# the reference's own compressed-vs-exact check (tests/test_dryrun_small.py:
# lr 1e-3, batch 8 over 4 data ways); here batch 4 over 2, the same two
# rows a group
TRACK = dict(lr=1e-3, warmup_steps=2, total_steps=20)
STEPS, TRACK_STEPS, TRACK_BATCH = 3, 6, 4


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600


# --- starting the subprocesses of a test -------------------------------------

def _start(args, io_dir, name, env_extra):
    env = dict(os.environ, **env_extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")])
    log = open(os.path.join(io_dir, f"{name}.log"), "w")
    return name, subprocess.Popen([sys.executable] + list(args), cwd=ROOT,
                                  env=env, stdout=log,
                                  stderr=subprocess.STDOUT), log


def start_job(job, io_dir):
    """The port's ranks of ``job`` (their output in ``<job>.log``)."""
    return _start(["-m", "test_torch_mesh_ranks", job, io_dir], io_dir, job,
                  {"OMP_NUM_THREADS": "1"})


def start_jax(code, io_dir, devices, name="jax"):
    """``python -c code`` on ``devices`` fake CPU devices."""
    return _start(["-c", code], io_dir, name, {
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
        "JAX_PLATFORMS": "cpu"})


def start_cli(args, io_dir, name="cli"):
    return _start(args, io_dir, name, {"OMP_NUM_THREADS": "1"})


def wait_all(io_dir, procs, timeout=TIMEOUT):
    """Wait for every started process; a timeout kills them all and fails
    the test instead of hanging it, and a failure shows its log and any
    rank's traceback."""
    deadline = time.time() + timeout
    try:
        for _, p, _ in procs:
            p.wait(timeout=max(1, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for _, p, _ in procs:
            p.kill()
        raise
    finally:
        for _, _, log in procs:
            log.close()
    for name, p, _ in procs:
        if p.returncode:
            errs = [open(os.path.join(io_dir, f)).read()
                    for f in sorted(os.listdir(io_dir)) if f.endswith(".err")]
            tail = open(os.path.join(io_dir, f"{name}.log")).read()[-3000:]
            raise AssertionError(f"{name} exited {p.returncode}:\n"
                                 + "\n".join(errs) + tail)


def read_log(io_dir, name):
    return open(os.path.join(io_dir, f"{name}.log")).read()


# --- helpers of the rank programs --------------------------------------------

def _init(rank: int, world: int, io_dir: str, job: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(io_dir, f"{job}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has none; f32 holds it exactly
        t = t.float()
    return t.numpy().copy()  # a replicated block aliases


def _tree_np(tree):
    from repro_torch.utils.tree import tree_leaves

    return [_full(x) for x in tree_leaves(tree)]


def _params(cfg, np_params):
    from repro_torch.models import api
    from repro_torch.utils.convert import load_jax_params
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda p: p.detach().clone(),
                    load_jax_params(api.init_model(cfg, 0, device="cpu"),
                                    np_params))


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


# --- job "steps": W=4, (2, 2) and (4,) meshes --------------------------------

def _psum(inp):
    """Two rounds of make_compressed_psum over a 4-way 'data' mesh, the
    residual fed back; levels and scales of each round."""
    from repro_torch.dist import collectives as coll
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("data",), device="cpu")
    rank = mesh.get_coordinate()[0]
    f = coll.make_compressed_psum(mesh, "data")
    err = torch.zeros(1, inp["psum_x"].shape[1])
    out = []
    for x in inp["psum_x"], inp["psum_x2"]:
        xl = torch.from_numpy(x[rank:rank + 1].copy())
        q, scale, _ = coll._quantize_int8(xl + err)
        coll.reset_wire_bytes()
        s, err = f(xl, err)
        out.append({"sum": s.numpy(), "err": err.numpy(), "q": q.numpy(),
                    "scale": float(scale), "wire": coll.wire_bytes()})
    return out


def _exact(inp, mesh, arch):
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_eval_step, make_train_step
    from repro_torch.utils import pspec

    cfg = get_config(arch, reduced=True)
    ctx = ShardingCtx(mesh, TRAIN_RULES)
    opt = AdamWConfig(**OPT)
    params = distribute_tree(_params(cfg, inp["params"][arch]), ctx,
                             pspec.logical_axes(api.model_specs(cfg)))
    state = init_state(params, opt)
    fw = {"remat": True}
    if cfg.family == "moe":
        fw["num_groups"] = 2
    step = make_train_step(cfg, opt, mesh=mesh, **fw)
    metrics = []
    for b in inp["batches"][arch]:
        params, state, m = step(params, state, b)
        metrics.append(_metrics(m))
    fw.pop("remat")
    return {"metrics": metrics, "params": _tree_np(params),
            "state": {k: _tree_np(state[k]) for k in ("w32", "m", "v")},
            "step": int(state["step"]),
            "eval": float(make_eval_step(cfg, mesh=mesh, **fw)(
                params, inp["batches"][arch][0]))}


def _compressed(inp, mesh):
    """The wire-compressed step: three steps at ``OPT`` (against the
    reference, and the wire bytes of each), then six steps of it and of
    the exact step at the reference's own tracking settings (``TRACK``).
    Every step runs under a ``CollectiveLog``: DTensor's own collectives,
    by op and mesh axis."""
    from repro_torch.configs import get_config
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils import pspec

    arch = ARCHS[0]
    cfg = get_config(arch, reduced=True)
    ctx = ShardingCtx(mesh, TRAIN_RULES)
    axes = pspec.logical_axes(api.model_specs(cfg))

    def run(opt_kw, compress, batches, grab=False):
        opt = AdamWConfig(compress_grads=compress, **opt_kw)
        params = distribute_tree(_params(cfg, inp["params"][arch]), ctx,
                                 axes)
        state = init_state(params, opt, grad_shards=2 if compress else 1)
        step = make_train_step(cfg, opt, mesh=mesh, remat=True)
        metrics, wire, dtensor = [], [], []
        for b in batches:
            coll.reset_wire_bytes()
            with coll.CollectiveLog(mesh) as log:
                params, state, m = step(params, state, b)
            wire.append(coll.wire_bytes())
            dtensor.append({"counts": log.counts,
                            "data": log.reductions_over("data"),
                            "model": log.reductions_over("model")})
            metrics.append(_metrics(m))
        out = {"metrics": metrics, "wire": wire, "dtensor": dtensor,
               "params": _tree_np(params)}
        if grab:
            out["state"] = {k: _tree_np(state[k])
                            for k in ("w32", "m", "v", "err")}
        return out

    return {"c": run(OPT, True, inp["batches"][arch], grab=True),
            "track_c": run(TRACK, True, inp["track_batches"]),
            "track_e": run(TRACK, False, inp["track_batches"])}


def _eval_and_kernels(inp, mesh):
    """The eval step on (2, 2) (plain versions on the CPU), and the
    kernels' local-shard dispatch with the plain versions as kernels."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                           distribute_tree, local_dtensor)
    from repro_torch.kernels import mesh as kmesh
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import api
    from repro_torch.train.train_step import make_eval_step
    from repro_torch.utils import pspec

    arch = ARCHS[0]
    cfg = get_config(arch, reduced=True).replace(use_kernels=True)
    ctx = ShardingCtx(mesh, TRAIN_RULES)
    params = distribute_tree(_params(cfg, inp["params"][arch]), ctx,
                             pspec.logical_axes(api.model_specs(cfg)))
    loss = float(make_eval_step(cfg, mesh=mesh)(params,
                                                 inp["batches"][arch][0]))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 32, generator=g)
    w = torch.randn(32, generator=g)
    q = torch.randn(2, 8, 4, 16, generator=g)
    k = torch.randn(2, 8, 2, 16, generator=g)
    v = torch.randn(2, 8, 2, 16, generator=g)
    cases = {}
    kmesh.REDISTRIBUTES.clear()
    for name, xl in (("rows", [Shard(0), Replicate()]),
                     ("rows_and_width", [Shard(0), Shard(2)])):
        xd = local_dtensor(x, mesh, xl)
        wd = local_dtensor(w, mesh, [Replicate(), Replicate()])
        before = kmesh.REDISTRIBUTES["rmsnorm"]
        out = kmesh.local_shards("rmsnorm",
                                 lambda a, b: rmsnorm_ref(a, b, 1e-6),
                                 (xd, wd), whole=((-1,), (0,)))
        cases[name] = (_full(out), kmesh.REDISTRIBUTES["rmsnorm"] - before)
    for name, ql, kl in (
            ("heads", [Shard(0), Shard(2)], [Shard(0), Shard(2)]),
            ("kv_replicated", [Shard(0), Shard(2)], [Shard(0), Replicate()]),
            ("head_dim", [Shard(0), Shard(3)], [Shard(0), Shard(3)])):
        args = (local_dtensor(q, mesh, ql), local_dtensor(k, mesh, kl),
                local_dtensor(v, mesh, kl))
        before = kmesh.REDISTRIBUTES["flash_attention"]
        out = kmesh.local_shards(
            "flash_attention",
            lambda a, b, c: attention_ref(a, b, c, True, None), args,
            whole=((1, 3),) * 3, same_layout=(1, 2))
        cases[name] = (_full(out),
                       kmesh.REDISTRIBUTES["flash_attention"] - before)
    refs = {"rows": rmsnorm_ref(x, w, 1e-6).numpy(),
            "rows_and_width": rmsnorm_ref(x, w, 1e-6).numpy()}
    for name in ("heads", "kv_replicated", "head_dim"):
        refs[name] = attention_ref(q, k, v, True, None).numpy()
    return {"eval_loss": loss, "kernels": cases, "kernel_refs": refs}


def _checkpoints(inp, mesh, io_dir):
    """Save the reference state as DTensors on (2, 2) through the
    multi-writer protocol; restore the JAX package's (4, 2) checkpoint
    onto (2, 2)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.checkpoint import CheckpointManager
    from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.launch.train import _build_state_axes
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.trainer import _save_kwargs
    from repro_torch.utils.tree import tree_leaves

    arch = ARCHS[0]
    cfg = get_config(arch, reduced=True)
    opt = AdamWConfig(**OPT)
    ctx = ShardingCtx(mesh, TRAIN_RULES)
    axes = _build_state_axes(cfg, opt)
    params = _params(cfg, inp["params"][arch])
    state = distribute_tree({"params": params,
                             "opt": init_state(params, opt)}, ctx, axes)
    mgr = CheckpointManager(os.path.join(io_dir, "ck_port22"), keep=2)
    dist.barrier()  # every manager has swept stale staging before any saves
    mgr.save(state, 7, **_save_kwargs(ctx, axes))
    restored, step = CheckpointManager(
        inp["ck_jax42"]).restore_latest(state, ctx=ctx, axes=axes)
    dist.barrier()
    kinds = sorted({type(x).__name__ for x in tree_leaves(restored)})
    return {"restored": _tree_np(restored), "restored_step": step,
            "restored_kinds": kinds}


def job_steps(rank: int, world: int, io_dir: str):
    from repro_torch.launch.mesh import make_mesh

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    t0 = time.time()
    out = {"psum": _psum(inp)}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for arch in ARCHS:
        out[arch] = _exact(inp, mesh, arch)
        print(f"[steps] {arch} {time.time() - t0:.1f}s", flush=True)
    out["compressed"] = _compressed(inp, mesh)
    print(f"[steps] compressed {time.time() - t0:.1f}s", flush=True)
    out.update(_eval_and_kernels(inp, mesh))
    out.update(_checkpoints(inp, mesh, io_dir))
    print(f"[steps] done {time.time() - t0:.1f}s", flush=True)
    return out


# --- job "one": W=1, a (1, 1) mesh against one device -------------------------

def job_one(rank: int, world: int, io_dir: str):
    """The exact mesh step and the mesh eval step on a (1, 1) mesh, and the
    one-device steps from the same parameters and batches: on a mesh of
    one rank every DTensor op runs the plain op, and the vocab-parallel
    lookup and loss reduce to the one-device ones, so the two should
    agree bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_eval_step, make_train_step

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        opt = AdamWConfig(**OPT)
        fw = {"num_groups": 2} if cfg.family == "moe" else {}
        params = _params(cfg, inp["params"][arch])
        state = init_state(params, opt)
        step = make_train_step(cfg, opt, remat=True, **fw)
        metrics = []
        for b in inp["batches"][arch]:
            params, state, m = step(params, state, b)
            metrics.append(_metrics(m))
        one = {"metrics": metrics, "params": _tree_np(params),
               "eval": float(make_eval_step(cfg, **fw)(
                   params, inp["batches"][arch][0]))}
        out[arch] = {"one": one, "mesh": _exact(inp, mesh, arch)}
    return out


# --- job "elastic": W=2, elastic_train on (2, 1) -----------------------------

def job_elastic(rank: int, world: int, io_dir: str):
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train as tlaunch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainLoopConfig

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    arch = ARCHS[0]
    cfg = get_config(arch, reduced=True)
    opt = AdamWConfig(**inp["opt"])
    injector = {"armed": True}

    def monitor_factory(n):
        dead_at = 4 if injector.pop("armed", None) else None
        return tlaunch.FailureInjector(num_workers=n, dead_at=dead_at,
                                       dead_worker=1)

    log = []
    p, _, hist = tlaunch.elastic_train(
        cfg, _params(cfg, inp["params"]),
        DataPipeline(cfg, seq_len=inp["seq"], global_batch=inp["batch"],
                     host_count=2), opt,
        TrainLoopConfig(total_steps=6, log_every=1, ckpt_every=2,
                        ckpt_dir=os.path.join(io_dir, "ck")),
        step_factory=tlaunch.make_step_factory(cfg, opt, on_mesh=True),
        mesh_shape=(2, 1), total_hosts=2, monitor_factory=monitor_factory,
        log_fn=log.append)
    return {"rank": rank, "hist": hist, "log": log, "left": p is None}


# --- job "serve": W=4, CHORDS serving on (2, 2) under SERVE_RULES -----------

SERVE_N, SERVE_K, SERVE_S, SERVE_LATENT = 12, 4, 2, 8
# the trace of test_torch_serve.py: (priority, rtol, deadline_rounds) per
# request, and one late request (rid, priority, rtol, deadline_rounds)
SERVE_REQS = [(0, None, None), (1, 0.5, 20), (0, 0.0, None), (2, None, 14),
              (0, 0.3, 30)]
SERVE_LATE = (9, 0, None, 10)
# (policy, rounds a device program) of the engine runs
SERVE_RUNS = (("fifo", 1), ("edf-preempt", 1), ("edf", 8))
SLOT_ROUNDS = 6  # rounds of the bare slot round body


def _dit(inp):
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper
    from repro_torch.utils.convert import load_jax_params

    cfg = get_config("chords-dit-xl", reduced=True)
    return cfg, load_jax_params(
        init_wrapper(cfg, SERVE_LATENT, device="cpu"), inp["dit"])


def _drive(eng, inp, r_dev=1, **req_kw):
    """The trace through ``eng``: {rid: (sample, rounds_used,
    accepted_core, latency_rounds)} and its stats()."""
    from repro_torch.serve import Request

    def req(i, prio, rtol, dl):
        return Request(rid=i, x0=inp["noise"][i], priority=prio, rtol=rtol,
                       deadline_rounds=dl, **req_kw)

    for i, (prio, rtol, dl) in enumerate(SERVE_REQS):
        eng.submit(req(i, prio, rtol, dl))
    done = []
    for _ in range(3):
        done += eng.step(max_rounds_on_device=r_dev)
    eng.submit(req(*SERVE_LATE))
    done += eng.run_until_drained(max_rounds_on_device=r_dev)
    return ({rid: (o.sample.numpy().copy(), o.rounds_used, o.accepted_core,
                   o.latency_rounds) for rid, o in done}, eng.stats())


def _state_layout(st):
    """Type names of every leaf of a SlotState, and its latent's global
    and local shapes."""
    from repro_torch.serve.executor import state_tensors

    x = st.carry.x
    return {"kinds": sorted({type(t).__name__ for t in state_tensors(st)}),
            "global": tuple(x.shape), "local": tuple(x.to_local().shape),
            "placements": [repr(p) for p in x.placements]}


def _serve_engines(inp, mesh, params, dparams, cfg):
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import SERVE_RULES, use_sharding
    from repro_torch.serve import ContinuousEngine

    tg = uniform_tgrid(SERVE_N)
    shape = (1, 16, SERVE_LATENT)
    out = {}

    def engine(drift, **kw):
        return ContinuousEngine(drift, shape, SERVE_N, SERVE_K, tg,
                                use_kernel=True, device="cpu", **kw)

    for policy, r_dev in SERVE_RUNS:
        one = _drive(engine(make_drift(params, cfg), num_slots=SERVE_S,
                            policy=policy), inp, r_dev)
        with use_sharding(mesh, SERVE_RULES):
            eng = engine(make_drift(dparams, cfg), num_slots=SERVE_S,
                         policy=policy)
        coll.reset_wire_bytes()
        with coll.CollectiveLog(mesh) as log:
            got = _drive(eng, inp, r_dev)
        out[(policy, r_dev)] = {"one": one, "mesh": got,
                                "log": dict(log.counts),
                                "wire": coll.wire_bytes(),
                                "layout": _state_layout(eng.state)}
    # lanes (adaptive requests), an elastic grid and the overlap loop (2
    # rounds a device program): against one device
    for name, kw, req_kw, r_dev in (
            ("lanes", {"num_slots": SERVE_S, "lane_profile": True},
             {"mode": "adaptive"}, 1),
            ("elastic", {"min_slots": 2, "max_slots": 4}, {}, 1),
            ("overlap", {"num_slots": SERVE_S, "overlap": True}, {}, 2)):
        one = _drive(engine(make_drift(params, cfg), **kw), inp, r_dev,
                     **req_kw)
        with use_sharding(mesh, SERVE_RULES):
            eng = engine(make_drift(dparams, cfg), **kw)
        out[name] = {"one": one,
                     "mesh": _drive(eng, inp, r_dev, **req_kw)}
    return out


def _serve_keys(mesh, dparams, cfg):
    """The sharding tag, and one executor asked for the same grid by a
    bare engine and by a mesh engine."""
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.dist.sharding import SERVE_RULES, use_sharding
    from repro_torch.serve import ContinuousEngine
    from repro_torch.serve.executor import RoundExecutor, \
        ambient_sharding_tag

    tg = uniform_tgrid(SERVE_N)
    ex = RoundExecutor(make_drift(dparams, cfg), tg, SERVE_N, use_kernel=True)
    shape = (1, 16, SERVE_LATENT)
    bare = ContinuousEngine(None, shape, SERVE_N, SERVE_K, tg,
                            num_slots=SERVE_S, executor=ex, device="cpu")
    with use_sharding(mesh, SERVE_RULES):
        tag = ambient_sharding_tag()
        on_mesh = ContinuousEngine(None, shape, SERVE_N, SERVE_K, tg,
                                   num_slots=SERVE_S, executor=ex,
                                   device="cpu")
    return {"tag": tag, "retraces": ex.retraces,
            "specs": (repr(bare.spec), repr(on_mesh.spec)),
            "outside": ambient_sharding_tag()}


def _slot_rounds(inp, mesh, params, dparams, cfg):
    """make_slot_round_body called directly: SLOT_ROUNDS rounds from the
    same admitted carry, on the mesh (DTensor state) and on one device."""
    from repro_torch.core.chords import ChordsCarry, make_slot_round_body
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           use_sharding)
    from repro_torch.serve.executor import place

    tg = uniform_tgrid(SERVE_N)
    x0 = torch.from_numpy(inp["slot_x0"])
    i_arr = torch.from_numpy(inp["slot_iarr"])
    k = SERVE_K
    x = x0[:, None].expand((x0.shape[0], k) + tuple(x0.shape[1:])).clone()
    carry = ChordsCarry(x, x.clone(), torch.zeros_like(x), i_arr.clone(),
                        torch.zeros_like(x))
    live = torch.ones(x0.shape[0], dtype=torch.bool)
    ctx = ShardingCtx(mesh, SERVE_RULES)
    runs = {}
    for name, drift, c in (
            ("one", make_drift(params, cfg), None),
            ("mesh", make_drift(dparams, cfg), ctx)):
        body = make_slot_round_body(drift, tg, SERVE_N, k)
        st = place(carry, c, "slots")
        ia, lv = place(i_arr, c, "slots"), place(live, c, "slots")
        for r in range(1, SLOT_ROUNDS + 1):
            rr = place(torch.full((x0.shape[0],), r, dtype=torch.int32), c,
                       "slots")
            if c is None:
                st, _ = body(st, ia, rr, lv)
            else:
                with use_sharding(mesh, SERVE_RULES):
                    st, _ = body(st, ia, rr, lv)
        runs[name] = [_full(t) for t in st]
    return runs


def _serve_static(inp, mesh, params, dparams, cfg):
    """ChordsEngine (the stream program, cores on data) on the mesh and on
    one device, and the bytes its rolls and readbacks put on the wire."""
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import make_drift
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import SERVE_RULES, use_sharding
    from repro_torch.serve import ChordsEngine, Request

    tg = uniform_tgrid(SERVE_N)

    def serve(drift, ctx_on):
        eng = ChordsEngine(drift, (16, SERVE_LATENT), SERVE_N, SERVE_K, tg,
                           max_batch=SERVE_S, use_kernel=True, device="cpu")
        for i in range(3):
            eng.submit(Request(rid=i, x0=inp["static_noise"][i]))
        done = []
        coll.reset_wire_bytes()
        while eng.queue:
            done += eng.step()
        return ({rid: (o.sample.numpy().copy(), o.rounds_used,
                       o.accepted_core) for rid, o in done},
                eng.total_rounds(), coll.wire_bytes(),
                eng.sampler.program.rounds_run)

    one = serve(make_drift(params, cfg), False)
    with use_sharding(mesh, SERVE_RULES):
        mesh_run = serve(make_drift(dparams, cfg), True)
    return {"one": one, "mesh": mesh_run}


def _hybrid_serve(inp, mesh):
    """The reduced zamba2 hybrid denoiser (seeded port weights) through
    ContinuousEngine on the mesh and on one device, and one SSD layer's
    kernel arrangement on a DTensor batch (``ssd_chunk`` on each rank's
    rows and heads block) against the plain call."""
    from repro_torch.configs import get_config
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import init_wrapper, make_drift
    from repro_torch.diffusion.wrapper import wrapper_specs
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree, local_dtensor,
                                           use_sharding)
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref
    from repro_torch.models import mamba2
    from repro_torch.serve import ContinuousEngine
    from repro_torch.utils import pspec

    cfg = get_config("zamba2-2.7b", reduced=True)
    ctx = ShardingCtx(mesh, SERVE_RULES)
    params = init_wrapper(cfg, SERVE_LATENT, device="cpu",
                          generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.05,
                                   generator=torch.Generator().manual_seed(6))
    dparams = distribute_tree(
        params, ctx, pspec.logical_axes(wrapper_specs(cfg, SERVE_LATENT)))
    tg = uniform_tgrid(SERVE_N)

    def engine(p):
        return ContinuousEngine(make_drift(p, cfg), (1, 16, SERVE_LATENT),
                                SERVE_N, SERVE_K, tg, num_slots=SERVE_S,
                                use_kernel=True, device="cpu")

    out = {"one": _drive(engine(params), inp)}
    with use_sharding(mesh, SERVE_RULES):
        eng = engine(dparams)
    out["mesh"] = _drive(eng, inp)
    ssd = params["backbone"]["mamba"]["ssd"]
    layer = {k: ssd[k][0] for k in ssd.keys()}
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(8))
    ref = mamba2.ssd_forward(layer, cfg, x, chunk_fn=ssd_chunk_batched_ref)
    with use_sharding(mesh, SERVE_RULES):
        got = mamba2.ssd_forward(
            layer, cfg, local_dtensor(x, mesh, ctx.placements(
                ("batch", "seq", "embed_act"), tuple(x.shape))),
            chunk_fn=ssd_chunk_batched_ref)
    out["ssd"] = ([_full(got[0]), _full(got[1][0]), _full(got[1][1])],
                  [ref[0].numpy(), ref[1][0].numpy(), ref[1][1].numpy()])
    return out


def _kernels_on_shards(mesh):
    """The step and accept kernels, ssd_chunk and the loop condition on
    DTensor operands (plain versions on the CPU) against the plain call
    on the whole tensors, and the redistributes counted."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import local_dtensor
    from repro_torch.kernels import mesh as kmesh
    from repro_torch.kernels.device_loop.ops import loop_step
    from repro_torch.kernels.device_loop.ref import EXIT_ON_ACCEPT, FIRST
    from repro_torch.kernels.rectify.ops import (step_rectify,
                                                 step_rectify_accept)
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk

    g = torch.Generator().manual_seed(7)
    rows = [Shard(0), Replicate()]
    lat = [torch.randn(8, 4, 16, generator=g) for _ in range(6)]
    vec = [torch.randn(8, generator=g), torch.randn(8, generator=g),
           torch.rand(8, generator=g) > 0.5]
    prev = torch.randn(4, 4, 16, generator=g)
    d = [local_dtensor(t, mesh, rows) for t in lat + vec]
    kmesh.REDISTRIBUTES.clear()
    out = {"step": (_full(step_rectify(*d, use_kernel=True)),
                    step_rectify(*lat, *vec).numpy())}
    for name, pv in (("accept_prev_dtensor", local_dtensor(prev, mesh, rows)),
                     ("accept_prev_plain", prev)):
        got = step_rectify_accept(*d[:6], pv, *d[6:], use_kernel=True)
        ref = step_rectify_accept(*lat, prev, *vec)
        out[name] = ([_full(t) for t in got], [t.numpy() for t in ref],
                     [repr(t.placements) for t in got])
    c = torch.randn(4, 8, 16, generator=g)
    b = torch.randn(4, 8, 16, generator=g)
    xdt = torch.randn(4, 4, 8, 8, generator=g)
    cum = -torch.rand(4, 4, 8, generator=g).cumsum(-1)
    heads = [Shard(0), Shard(1)]
    got = ssd_chunk(local_dtensor(c, mesh, rows), local_dtensor(b, mesh, rows),
                    local_dtensor(xdt, mesh, heads),
                    local_dtensor(cum, mesh, heads), use_kernel=True)
    out["ssd_chunk"] = ([_full(t) for t in got],
                        [t.numpy() for t in ssd_chunk(c, b, xdt, cum)],
                        [repr(t.placements) for t in got])
    # the loop condition: rank data-block 0 holds a new accept, block 1 none
    live = torch.tensor([True, False, True, True])
    done0 = torch.tensor([False, False, False, False])
    done = torch.tensor([False, True, False, False])
    ctrl = torch.tensor([8, 0, 0, 0], dtype=torch.int32)
    dd = local_dtensor(done0.clone(), mesh, rows)
    go0 = int(loop_step(local_dtensor(live, mesh, rows),
                        local_dtensor(done0, mesh, rows), dd, ctrl,
                        EXIT_ON_ACCEPT | FIRST))
    go1 = int(loop_step(local_dtensor(live, mesh, rows),
                        local_dtensor(done, mesh, rows), dd, ctrl,
                        EXIT_ON_ACCEPT))
    out["loop"] = (go0, go1, ctrl.tolist())
    out["redistributes"] = dict(kmesh.REDISTRIBUTES)
    return out


def job_serve(rank: int, world: int, io_dir: str):
    from repro_torch.diffusion.wrapper import wrapper_specs
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    t0 = time.time()
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg, params = _dit(inp)
    dparams = distribute_tree(
        params, ShardingCtx(mesh, SERVE_RULES),
        pspec.logical_axes(wrapper_specs(cfg, SERVE_LATENT)))
    out = {}
    with torch.no_grad():
        out["engines"] = _serve_engines(inp, mesh, params, dparams, cfg)
        print(f"[serve] engines {time.time() - t0:.1f}s", flush=True)
        out["keys"] = _serve_keys(mesh, dparams, cfg)
        out["slot_rounds"] = _slot_rounds(inp, mesh, params, dparams, cfg)
        out["static"] = _serve_static(inp, mesh, params, dparams, cfg)
        out["kernels"] = _kernels_on_shards(mesh)
        out["hybrid"] = _hybrid_serve(inp, mesh)
    print(f"[serve] done {time.time() - t0:.1f}s", flush=True)
    return out


# --- job "lm_serve": W=4, LM prefill and greedy decode on (2, 2) -------------

LM_SERVE_ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b", "zamba2-2.7b", "xlstm-1.3b",
                  "seamless-m4t-medium")
LM_B, LM_S0, LM_MAX, LM_DECODE = 2, 16, 32, 6  # S0: whole SSD chunks
# (key, arch, mesh, prompt length): every family on (2, 2), and zamba2 also
# on (1, 4), where its 8 SSD heads are 2 a rank, and on (2, 2) with a
# prompt of 64 tokens a rank, above ``mamba2.by_heads``'s crossover (47.9
# at the reduced widths), so that its prefill gathers the SSD parameters
LM_SERVE_RUNS = tuple((a, a, (2, 2), LM_S0) for a in LM_SERVE_ARCHS) + (
    ("zamba2-2.7b@1x4", "zamba2-2.7b", (1, 4), LM_S0),
    ("zamba2-2.7b@s64", "zamba2-2.7b", (2, 2), 64))
LM_SRC = 8  # enc-dec source frames


def lm_max_len(prompt_len: int) -> int:
    """The cache length of a prompt: ``LM_MAX`` for ``LM_S0`` tokens."""
    return prompt_len + LM_MAX - LM_S0


def _lm_run(cfg, params, prompt, src=None, log_mesh=None):
    """Prefill logits, greedy tokens and the logits of each decode step
    (fed its own greedy tokens), and the cache's leaves' layout. The
    tokens come from ``greedy_generate``, enc-dec's (which it does not
    take) from the decode loop. With ``log_mesh``, each decode step's
    collectives (:func:`_shape_log`), the cache's local blocks and the
    prefill's cache (whole, with each leaf's dtype)."""
    from repro_torch.serve import greedy_generate, make_decode_step, \
        make_prefill

    extra = () if src is None else (src,)
    max_len = lm_max_len(prompt.shape[1])
    logits, cache = make_prefill(cfg, max_len)(params, prompt, *extra)
    out = {"prefill": _full(logits), "decode": []}
    out["cache"] = {k: repr(getattr(v, "placements", None))
                    for k, v in cache.items()}
    dec = make_decode_step(cfg)
    toks = [torch.from_numpy(out["prefill"][:, -1:].argmax(-1)).to(
        torch.int32)]
    if log_mesh is not None:
        out["blocks"], out["shapes"] = _cache_blocks(cache), []
        out["prefill_cache"] = {k: (_full(v), v.dtype)
                                for k, v in cache.items()}
    for _ in range(LM_DECODE):
        with (_shape_log(log_mesh) if log_mesh is not None
              else contextlib.nullcontext()) as log:
            logits, cache = dec(params, toks[-1], cache)
        if log is not None:
            out["shapes"].append(list(log.shapes))
        out["decode"].append(_full(logits))
        toks.append(torch.from_numpy(out["decode"][-1].argmax(-1)).to(
            torch.int32))
    loop = torch.cat([prompt.to(torch.int32)] + toks, dim=1)
    out["tokens"] = loop.numpy() if src is not None else _full(
        greedy_generate(cfg, params, prompt, LM_DECODE + 1, max_len))
    return out


def job_lm_serve(rank: int, world: int, io_dir: str):
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree, use_sharding)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    t0 = time.time()
    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
              for shape in {shape for _, _, shape, _ in LM_SERVE_RUNS}}
    out = {}
    with torch.no_grad():
        for key, arch, shape, _ in LM_SERVE_RUNS:
            mesh = meshes[shape]
            ctx = ShardingCtx(mesh, SERVE_RULES)
            cfg = get_config(arch, reduced=True)
            params = _params(cfg, inp["params"][arch])
            prompt = torch.from_numpy(inp["prompt"][key])
            src = inp["src"].get(arch)
            src = None if src is None else torch.from_numpy(src)
            one = _lm_run(cfg, params, prompt, src)
            dparams = distribute_tree(
                params, ctx, pspec.logical_axes(api.model_specs(cfg)))
            with use_sharding(mesh, SERVE_RULES):
                on_mesh = _lm_run(cfg, dparams, prompt, src)
                axes = api.get_module(cfg).cache_axes(cfg)
                want = {k: repr(ctx.placements(ax)) for k, ax in axes.items()
                        if k != "len"}
            out[key] = {"one": one, "mesh": on_mesh, "want": want}
            print(f"[lm_serve] {key} {time.time() - t0:.1f}s", flush=True)
    return out


# --- job "analysis": W=4, the sharding pass of repro_torch.analysis ----------

def job_analysis(rank: int, world: int, io_dir: str):
    """``sharding_check`` over both ladders of the analysis surface on a
    (2, 2) mesh under ``SERVE_RULES``, then two mutants of the grid's
    state on the smallest grid: ``rtol`` left whole (``replicated``) and
    ``rtol`` laid out on ``model`` instead of ``data`` (``entry-spec``)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.analysis import sharding_check, surface
    from repro_torch.dist.sharding import local_dtensor, whole
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import executor as ex_mod

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ex = surface.make_executor()
    ladders = surface.grid_ladder() + surface.lane_grid_ladder()
    out = {"grids": len(ladders),
           "clean": [(f.location, f.code) for f in sharding_check.run(
               ex, ladders, mesh=mesh)]}
    place = ex_mod.place
    for name, lay in (("replicated", (Replicate(), Replicate())),
                      ("entry_spec", (Replicate(), Shard(0)))):
        def mutant(tree, ctx, axis, lay=lay):
            st = place(tree, ctx, axis)
            if not isinstance(st, ex_mod.SlotState) or ctx is None:
                return st
            return st._replace(rtol=local_dtensor(
                whole(st.rtol).clone(), ctx.mesh, lay))
        ex_mod.place = mutant
        try:
            out[name] = [(f.location, f.code) for f in sharding_check.run(
                ex, ladders[:1], mesh=mesh)]
        finally:
            ex_mod.place = place
    return out


# --- job "layouts": W=4, the layouts a production mesh forces ---------------

# (name, arch, mesh, microbatches, batch, config changes): a train step
# whose layout takes a re-layout only a wide mesh needs, against one device
LAYOUT_TRAIN = (
    # 2 microbatches of 8 rows on 4 data ranks: the rows made whole first
    ("rows", "qwen1.5-0.5b", (4, 1), 2, 8, {}),
    # 3 kv heads on 2 model ranks under TRAIN_RULES: k/v split by head_dim
    # over model, embed over data (FSDP), gathered before the product (as
    # internlm2-1.8b's 8 kv heads on the pod's 16 model ranks)
    ("kv_heads", "internlm2-1.8b", (2, 2), 1, 4,
     {"num_heads": 6, "num_kv_heads": 3, "head_dim": 16}),
    # the layouts whose local blocks DTensor viewed in other strides than
    # their global view's (``sharding.conform``): one expert a model rank
    # (the expert products), the enc-dec step's backward (the q/k/v
    # products' gradients), and xLSTM's 2 heads over 4 model ranks (the
    # mLSTM products; the sLSTM cell on each rank's rows)
    ("experts", "olmoe-1b-7b", (2, 2), 1, 4, {"num_experts": 2}),
    ("encdec", "seamless-m4t-medium", (2, 2), 1, 4, {}),
    ("xlstm_heads", "xlstm-1.3b", (1, 4), 1, 4, {}),
    # zamba2's SSD layers with their parameters gathered (FSDP-split under
    # TRAIN_RULES) on each rank's rows, the rows split over data: each
    # gathered parameter's gradient a sum over the row splits
    # (``sharding.whole_for_rows``)
    ("ssd_rows", "zamba2-2.7b", (2, 2), 1, 4, {}),
)
LAYOUT_STEPS, LAYOUT_SEQ = 2, 16
# the functions that re-lay a DTensor out only where a mesh forces it
LAYOUT_REDISTRIBUTORS = ("split", "_tp_only", "split_last")


def _count_redistributes(names):
    """{name: calls to ``DTensor.redistribute`` made from a function of
    that name}, counted from now on in this process."""
    from torch.distributed.tensor import DTensor

    hits = dict.fromkeys(names, 0)
    orig = DTensor.redistribute

    def redistribute(self, *args, **kwargs):
        caller = sys._getframe(1).f_code.co_name
        if caller in hits:
            hits[caller] += 1
        return orig(self, *args, **kwargs)

    DTensor.redistribute = redistribute
    return hits


def _layout_train(arch, shape, nm, batch, changes, hits):
    """``LAYOUT_STEPS`` exact train steps on ``shape`` (TRAIN_RULES) and on
    one device, from the same seeded parameters and batches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (TRAIN_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.utils import pspec
    from repro_torch.utils.tree import tree_map

    cfg = get_config(arch, reduced=True).replace(**changes)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    rng = np.random.default_rng(7)
    batches = [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, LAYOUT_SEQ)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(LAYOUT_STEPS)]
    if api.is_encdec(cfg):
        for b in batches:
            b["src_embeds"] = torch.from_numpy(rng.standard_normal(
                (batch, LM_SRC, cfg.d_model)).astype(np.float32))
    opt = AdamWConfig(**OPT)
    out = {}
    for where in ("one", "mesh"):
        params = api.init_model(cfg, 0, device="cpu")
        step = make_train_step(cfg, opt, num_microbatches=nm, remat=True)
        if where == "mesh":
            params = distribute_tree(params, ShardingCtx(mesh, TRAIN_RULES),
                                     pspec.logical_axes(api.model_specs(cfg)))
            step = make_train_step(cfg, opt, num_microbatches=nm, mesh=mesh,
                                   remat=True)
            before = dict(hits)
        state = init_state(params, opt)
        metrics = []
        for b in batches:
            params, state, m = step(params, state, tree_map(
                lambda x: x.clone(), b))
            metrics.append(_metrics(m))
        out[where] = {"metrics": metrics, "params": _tree_np(params)}
    out["redistributed"] = {k: hits[k] - before[k] for k in hits}
    return out


def _layout_serve(hits):
    """Reduced xLSTM (2 heads) decoding on (1, 4) under SERVE_RULES from
    an empty cache, against one device: its 2 heads do not divide the 4
    model ranks, so the head view of the model-split inner dim is made
    whole first (``split_last``); the cache is ``init_cache`` under the
    context (every rank allocates its block only). And the empty cache of
    a dense prefill on (2, 2), leaf by leaf."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree, use_sharding)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, dense
    from repro_torch.serve import make_decode_step
    from repro_torch.utils import pspec

    out = {}
    cfg = get_config("xlstm-1.3b", reduced=True)
    mod = api.get_module(cfg)
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    ctx = ShardingCtx(mesh, SERVE_RULES)
    params = api.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (LM_B, LM_DECODE)).astype(np.int32))
    specs = mod.cache_specs(cfg, LM_B)
    dec = make_decode_step(cfg)
    run = {}
    with torch.no_grad():
        for where in ("one", "mesh"):
            with contextlib.ExitStack() as stack:
                p = params
                if where == "mesh":
                    p = distribute_tree(params, ctx, pspec.logical_axes(
                        api.model_specs(cfg)))
                    stack.enter_context(use_sharding(mesh, SERVE_RULES))
                    before = dict(hits)
                cache = mod.init_cache(cfg, LM_B, device="cpu")
                run[where] = {"cache": {k: repr(getattr(v, "placements",
                                                        None))
                                        for k, v in cache.items()},
                              "decode": []}
                for i in range(LM_DECODE):
                    logits, cache = dec(p, toks[:, i:i + 1], cache)
                    run[where]["decode"].append(_full(logits))
    out["xlstm"] = {
        **run, "heads": cfg.num_heads,
        "redistributed": {k: hits[k] - before[k] for k in hits},
        "want": {k: repr(ctx.placements(ax, tuple(specs[k][0])))
                 for k, ax in mod.cache_axes(cfg).items() if k != "len"}}

    # xLSTM's prefill (whole chunks) and a decode step: on (2, 2) one head a
    # model rank, on (1, 4) two heads over four
    prompt = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (LM_B, LM_S0)).astype(np.int32))
    out["xlstm_prefill"] = {}
    with torch.no_grad():
        one = _lm_run(cfg, params, prompt)
        for shape in ((2, 2), (1, 4)):
            m = make_mesh(shape, ("data", "model"), device="cpu")
            p = distribute_tree(params, ShardingCtx(m, SERVE_RULES),
                                pspec.logical_axes(api.model_specs(cfg)))
            with use_sharding(m, SERVE_RULES):
                out["xlstm_prefill"]["x".join(map(str, shape))] = {
                    "one": one, "mesh": _lm_run(cfg, p, prompt)}

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ctx = ShardingCtx(mesh, SERVE_RULES)
    specs = dense.cache_specs(cfg, 2, 8)
    with use_sharding(mesh, SERVE_RULES):
        cache = dense.init_cache(cfg, 2, 8, device="cpu")
    axes = dense.cache_axes(cfg)
    out["zeros"] = {k: {
        "dtensor": hasattr(v, "to_local"),
        "placements": repr(getattr(v, "placements", None)),
        "want": None if k == "len" else repr(ctx.placements(
            axes[k], tuple(specs[k][0]))),
        "local": list((v.to_local() if hasattr(v, "to_local") else v).shape),
        "global": list(v.shape), "dtype": str(v.dtype),
        "spec": [list(specs[k][0]), str(specs[k][1])],
        "device": str((v.to_local() if hasattr(v, "to_local")
                       else v).device),
        "nonzero": int(((v.full_tensor() if hasattr(v, "full_tensor")
                         else v) != 0).sum())}
        for k, v in cache.items()}
    return out


def job_layouts(rank: int, world: int, io_dir: str):
    t0 = time.time()
    hits = _count_redistributes(LAYOUT_REDISTRIBUTORS)
    out = {}
    for name, arch, shape, nm, batch, changes in LAYOUT_TRAIN:
        out[name] = _layout_train(arch, shape, nm, batch, changes, hits)
        print(f"[layouts] {name} {time.time() - t0:.1f}s", flush=True)
    out.update(_layout_serve(hits))
    print(f"[layouts] done {time.time() - t0:.1f}s", flush=True)
    return out


# --- jobs "ssd_heads" (W=4) and "ssd_one" (W=1): zamba2's SSD layer ------

SSD_FEW, SSD_MANY = (2, 16), (4, 16)  # [B, S]: 32 and 64 tokens a rank


def _ssd_layer(mesh):
    """Reduced zamba2's first SSD layer (seeded port weights, norm weight
    off 1), whole and laid out on ``mesh`` under ``SERVE_RULES``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree)
    from repro_torch.models import api, mamba2
    from repro_torch.utils import pspec

    cfg = get_config("zamba2-2.7b", reduced=True)
    ssd = api.init_model(cfg, 0, device="cpu")["mamba"]["ssd"]
    layer = {k: ssd[k][0].detach().clone() for k in ssd.keys()}
    layer["gate_norm"] = 1.0 + 0.1 * torch.randn(
        layer["gate_norm"].shape, generator=torch.Generator().manual_seed(3))
    dlayer = distribute_tree(layer, ShardingCtx(mesh, SERVE_RULES),
                             pspec.logical_axes(mamba2.ssd_specs(cfg)))
    return cfg, layer, dlayer


def _shape_log(mesh):
    """A ``collectives.CollectiveLog`` that also keeps, in order, each
    collective's (op, axis, input shapes) in ``log.shapes``."""
    from repro_torch.dist.collectives import NOT_COLLECTIVES, CollectiveLog

    class ShapeLog(CollectiveLog):
        def __init__(self):
            super().__init__(mesh)
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func._overloadpacket.__name__.rstrip("_")
            if out is not NotImplemented and func.namespace in (
                    "_c10d_functional", "c10d_functional") \
                    and name not in NOT_COLLECTIVES:
                group = args[-1] if isinstance(args[-1], str) else \
                    (kwargs or {}).get("group_name")
                ts = args[0] if isinstance(args[0], (list, tuple)) \
                    else [args[0]]
                self.shapes.append((name, self.axes.get(group, "?"),
                                    tuple(tuple(t.shape) for t in ts)))
            return out

    return ShapeLog()


def _ssd_calls(cfg, layer, x, tok, log_mesh=None):
    """The layer's forward over ``x`` from zero states, then a decode step
    of ``tok`` from its states: outputs and states (whole), and with
    ``log_mesh`` the collectives of each call (:func:`_shape_log`)."""
    from repro_torch.models import mamba2

    out = {}
    for name, fn in (("forward", lambda: mamba2.ssd_forward(layer, cfg, x)),
                     ("decode", lambda: mamba2.ssd_decode_step(
                         layer, cfg, tok, *out["forward"][1]))):
        with (_shape_log(log_mesh) if log_mesh is not None
              else contextlib.nullcontext()) as log:
            y, st = fn()
        out[name] = (y, st, None if log is None else log)
    res = {}
    for name, (y, st, log) in out.items():
        res[name] = {"y": _full(y), "conv": _full(st[0]), "ssm": _full(st[1]),
                     "layout": [repr(getattr(t, "placements", None))
                                for t in st]}
        if log is not None:
            res[name]["shapes"] = list(log.shapes)
    return res


def job_ssd_heads(rank: int, world: int, io_dir: str):
    """The SSD layer on (1, 4) under ``SERVE_RULES`` at 32 and at 64
    tokens a rank (either side of the crossover of ``mamba2.by_heads``),
    beside one device; the shapes of the layer's local parameter blocks
    and SSM state block."""
    from repro_torch.dist.sharding import (SERVE_RULES, local_dtensor,
                                           ShardingCtx, use_sharding)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mamba2

    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    ctx = ShardingCtx(mesh, SERVE_RULES)
    cfg, layer, dlayer = _ssd_layer(mesh)
    gen = torch.Generator().manual_seed(9)
    out = {"params": {k: tuple(v.to_local().shape)
                      for k, v in dlayer.items()},
           "ranks": 4, "d": cfg.d_model}
    with torch.no_grad():
        for name, (b, s) in (("few", SSD_FEW), ("many", SSD_MANY)):
            x = torch.randn(b, s, cfg.d_model, generator=gen)
            tok = torch.randn(b, 1, cfg.d_model, generator=gen)
            one = _ssd_calls(cfg, layer, x, tok)
            lay = ctx.placements(("batch", "seq", "embed_act"), (b, s, 1))
            with use_sharding(mesh, SERVE_RULES):
                on_mesh = _ssd_calls(cfg, dlayer, local_dtensor(x, mesh, lay),
                                     local_dtensor(tok, mesh, lay), mesh)
            out[name] = {"one": one, "mesh": on_mesh, "tokens": b * s,
                         "by_heads": mamba2.by_heads(cfg, b * s, 4)}
    return out


def job_ssd_one(rank: int, world: int, io_dir: str):
    """The SSD layer and reduced zamba2's prefill and greedy decode on a
    (1, 1) mesh against one device, in f32 and bf16 (by heads: a model
    axis of one rank)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree, local_dtensor,
                                           use_sharding)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.utils import pspec

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    ctx = ShardingCtx(mesh, SERVE_RULES)
    cfg, layer, dlayer = _ssd_layer(mesh)
    gen = torch.Generator().manual_seed(10)
    x = torch.randn(*SSD_MANY, cfg.d_model, generator=gen)
    tok = torch.randn(SSD_MANY[0], 1, cfg.d_model, generator=gen)
    lay = ctx.placements(("batch", "seq", "embed_act"), (1, 1, 1))
    out = {}
    with torch.no_grad():
        out["layer"] = {"one": _ssd_calls(cfg, layer, x, tok)}
        with use_sharding(mesh, SERVE_RULES):
            out["layer"]["mesh"] = _ssd_calls(
                cfg, dlayer, local_dtensor(x, mesh, lay),
                local_dtensor(tok, mesh, lay))
        prompt = torch.randint(0, 256, (LM_B, LM_S0),
                               generator=torch.Generator().manual_seed(11))
        for dt in ("float32", "bfloat16"):
            lcfg = get_config("zamba2-2.7b", reduced=True).replace(
                compute_dtype=dt, param_dtype=dt)
            params = api.init_model(lcfg, 0, device="cpu")
            dp = distribute_tree(params, ctx, pspec.logical_axes(
                api.model_specs(lcfg)))
            run = {"one": _lm_run(lcfg, params, prompt)}
            with use_sharding(mesh, SERVE_RULES):
                run["mesh"] = _lm_run(lcfg, dp, prompt)
            out[dt] = run
    return out


# --- job "kv_seq": W=4, decode over a KV cache split along its sequence ----

# (key, arch, mesh): batch 1 under SERVE_RULES, so that ``data`` (which
# the batch cannot take) falls back to the caches' ``kv_seq``; on (4, 1)
# a rank holds 8 of the 32 positions, and the last block stays wholly
# past the length through the 6 decode steps
KV_SEQ_RUNS = tuple((f"{a}@{m[0]}x{m[1]}", a, m)
                    for a in ("qwen1.5-0.5b", "zamba2-2.7b",
                              "seamless-m4t-medium")
                    for m in ((2, 2), (4, 1)))
KV_SEQ_B = 1
# the direct attend_decode case: [B, Smax, KV, G, Dh] and per-row lengths
# (row 0's blocks past the first are wholly masked on (4, 1))
KV_SEQ_ATTN = (2, 32, 2, 2, 16)
KV_SEQ_LENS = (5, 27)


def _cache_blocks(cache):
    """The local block shape of one layer of each k/v cache leaf."""
    return {k: tuple(v.to_local().shape[1:]) for k, v in cache.items()
            if k in ("k", "v", "ck", "cv") and hasattr(v, "to_local")}


def _kv_seq_attn(mesh):
    """``attend_decode`` alone on DTensor q / caches whose sequence is
    split over ``data`` (and kv heads over ``model``), with the
    reference's int32 [B] lengths and with a host length, beside one
    device; the collectives of each call."""
    from repro_torch.dist.sharding import local_dtensor
    from repro_torch.models import layers as L
    from torch.distributed.tensor import Replicate, Shard

    b, smax, kvh, g, dh = KV_SEQ_ATTN
    gen = torch.Generator().manual_seed(12)
    q = torch.randn(b, 1, kvh * g, dh, generator=gen)
    k = torch.randn(b, smax, kvh, dh, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, smax, kvh, dh, generator=gen).to(torch.bfloat16)
    heads = Shard(2) if mesh.shape[1] > 1 else Replicate()
    dq = local_dtensor(q, mesh, (Replicate(), heads))
    dk, dv = (local_dtensor(t, mesh, (Shard(1), heads)) for t in (k, v))
    out = {}
    for name, cur in (("lens", torch.tensor(KV_SEQ_LENS, dtype=torch.int32)),
                      ("host", KV_SEQ_LENS[0])):
        with _shape_log(mesh) as log:
            got = L.attend_decode(dq, dk, dv, cur)
        out[name] = {"one": _full(L.attend_decode(q, k, v, cur)),
                     "mesh": _full(got), "shapes": list(log.shapes),
                     "counts": dict(log.counts)}
    return out


def _decode_from(cfg, params, run):
    """One device's decode steps from ``run``'s prefill cache, fed
    ``run``'s greedy tokens: each step's logits."""
    from repro_torch.serve import make_decode_step

    cache = {k: torch.from_numpy(a.copy()).to(dt)
             for k, (a, dt) in run.pop("prefill_cache").items()}
    dec, out = make_decode_step(cfg), []
    fed = [run["prefill"]] + run["decode"][:-1]
    for logits in fed:
        tok = torch.from_numpy(logits[:, -1:].argmax(-1)).to(torch.int32)
        step, cache = dec(params, tok, cache)
        out.append(_full(step))
    return out


def job_kv_seq(rank: int, world: int, io_dir: str):
    """Reduced dense, zamba2 and enc-dec at batch 1 on (2, 2) and on
    (4, 1) under ``SERVE_RULES``: prefill and greedy decode on the mesh
    (the decode steps' collectives logged) and on one device; then
    attend_decode alone on both meshes."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           distribute_tree, use_sharding)
    from repro_torch.kernels import mesh as kmesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    t0 = time.time()
    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
              for shape in {shape for _, _, shape in KV_SEQ_RUNS}}
    out = {"attn": {}}
    with torch.no_grad():
        for key, arch, shape in KV_SEQ_RUNS:
            mesh = meshes[shape]
            ctx = ShardingCtx(mesh, SERVE_RULES)
            cfg = get_config(arch, reduced=True)
            params = _params(cfg, inp["params"][arch])
            prompt = torch.from_numpy(inp["prompt"][key])
            src = inp["src"].get(arch)
            src = None if src is None else torch.from_numpy(src)
            one = _lm_run(cfg, params, prompt, src)
            dparams = distribute_tree(
                params, ctx, pspec.logical_axes(api.model_specs(cfg)))
            kmesh.REDISTRIBUTES.clear()
            with use_sharding(mesh, SERVE_RULES):
                on_mesh = _lm_run(cfg, dparams, prompt, src, log_mesh=mesh)
            on_mesh["redistributes"] = dict(kmesh.REDISTRIBUTES)
            out[key] = {"one": one, "mesh": on_mesh,
                        "resumed": _decode_from(cfg, params, on_mesh)}
            print(f"[kv_seq] {key} {time.time() - t0:.1f}s", flush=True)
        for shape, mesh in sorted(meshes.items()):
            out["attn"][shape] = _kv_seq_attn(mesh)
    print(f"[kv_seq] done {time.time() - t0:.1f}s", flush=True)
    return out


JOBS = {"steps": (job_steps, 4), "one": (job_one, 1),
        "elastic": (job_elastic, 2), "serve": (job_serve, 4),
        "lm_serve": (job_lm_serve, 4), "analysis": (job_analysis, 4),
        "layouts": (job_layouts, 4), "ssd_heads": (job_ssd_heads, 4),
        "ssd_one": (job_ssd_one, 1), "kv_seq": (job_kv_seq, 4)}


def _rank(rank: int, job: str, world: int, io_dir: str):
    _init(rank, world, io_dir, job)
    import torch.distributed as dist

    try:
        out = JOBS[job][0](rank, world, io_dir)
        if job == "elastic":  # every rank's own outcome
            with open(os.path.join(io_dir, f"{job}.rank{rank}.pkl"),
                      "wb") as f:
                pickle.dump(out, f)
        elif rank == 0:
            with open(os.path.join(io_dir, f"{job}.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(io_dir, f"{job}.rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(job: str, io_dir: str):
    import torch.multiprocessing as mp

    world = JOBS[job][1]
    mp.start_processes(_rank, args=(job, world, io_dir), nprocs=world,
                       start_method="spawn")


# --- tests of the helpers that need no ranks ---------------------------------

def test_local_block_tiles_the_tensor():
    """``local_block`` at every coordinate of a fake (2, 2) mesh tiles a
    tensor sharded on two dims, and on one dim over both mesh axes (the
    earlier mesh axis outer, as JAX's ("pod", "data") batch)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import local_block

    class Mesh:
        shape = (2, 2)

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    x = torch.arange(8 * 6).reshape(8, 6)
    for lay, block in (([Shard(0), Shard(1)], (4, 3)),
                       ([Shard(0), Shard(0)], (2, 6)),
                       ([Replicate(), Shard(1)], (8, 3))):
        seen = torch.zeros_like(x)
        for c in ((0, 0), (0, 1), (1, 0), (1, 1)):
            b = local_block(x, Mesh(c), lay)
            assert tuple(b.shape) == block
            seen[b.reshape(-1) // 6, b.reshape(-1) % 6] += 1
        per = 4 * block[0] * block[1] // x.numel()
        assert (seen == per).all(), lay
    # both mesh axes on dim 0: coordinate (a, b) holds rows block 2a + b
    b = local_block(x, Mesh((1, 0)), [Shard(0), Shard(0)])
    assert torch.equal(b, x[4:6])


def test_spec_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import spec_placements

    names = ("pod", "data", "model")
    assert spec_placements((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert spec_placements((None, None), names) == (Replicate(),) * 3
    try:
        spec_placements((("data", "pod"),), names)
    except ValueError as e:
        assert "mesh order" in str(e)
    else:
        raise AssertionError("an out-of-order spec entry must raise")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])


def test_mesh_needs_enough_ranks(tmp_path):
    """``make_mesh`` over the first ranks of the default group;
    ``make_production_mesh`` says how many devices it needs, as the
    reference's; ``dp_size`` counts pod x data."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import dp_size, make_mesh, \
        make_production_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert dp_size(mesh) == 1
        for multi, need in ((False, 256), (True, 512)):
            try:
                make_production_mesh(multi_pod=multi, device="cpu")
            except RuntimeError as e:
                assert f"need {need} devices" in str(e)
            else:
                raise AssertionError("a world of 1 made a production mesh")
        try:
            make_mesh((2, 1), ("data", "model"), device="cpu")
        except RuntimeError as e:
            assert "need 2 ranks" in str(e)
        else:
            raise AssertionError("a world of 1 made a mesh of 2")
    finally:
        dist.destroy_process_group()
