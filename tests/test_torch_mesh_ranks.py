"""The port's side of the mesh tests: programs that run on W gloo ranks of
the CPU, each rank a process of its own, and write what they computed for
the tests in ``test_torch_mesh_steps.py`` and ``test_torch_mesh_launch.py``
to compare with the JAX package. Imports no JAX.

    PYTHONPATH=src:tests python -m test_torch_mesh_ranks <job> <io_dir>

reads ``<io_dir>/inputs.pkl`` and writes ``<io_dir>/<job>.pkl`` (rank 0).
Ranks meet through a FileStore in ``io_dir`` (no TCP port: the suite runs
in parallel workers), run one intra-op thread each, and a rank that fails
writes its traceback to ``<io_dir>/<job>.rank<r>.err``.

The tests here hold the helpers that need no ranks.
"""
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
    return t.detach().cpu().numpy().copy()  # a replicated block aliases


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


JOBS = {"steps": (job_steps, 4), "one": (job_one, 1),
        "elastic": (job_elastic, 2)}


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
