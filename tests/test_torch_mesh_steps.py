"""Training on a device mesh: the port on four gloo ranks of the CPU
against the JAX package on four fake CPU devices.

One module fixture runs both sides once, at the same time, in
subprocesses: ``test_torch_mesh_ranks.py``'s job ``steps`` (the port; four
ranks, FileStore rendezvous, one thread each) and :func:`_jax_side` (the
reference, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``). Both
read the same inputs: the JAX package's initial parameters of reduced
``qwen1.5-0.5b`` and ``olmoe-1b-7b`` (f32; norm weights drawn off 1) and
the reference pipeline's batches (B 4 x S 16).

- ``make_compressed_psum`` over a 4-way ``data`` mesh, two rounds with the
  residual fed back: levels, scales and residual bitwise, sums within 1e-6
  relative, and only int8 levels and one f32 scale a rank on the wire.
- The exact mesh step on ``(data 2, model 2)`` (``TRAIN_RULES``), three
  chained steps: against the reference's ``make_train_step`` under
  ``use_sharding``, and against the port's own one-device step: loss
  within 1e-5 relative, ``grad_norm`` 1e-6, each leaf of params, ``w32``,
  ``m``, ``v`` 1e-5 relative L2 (the limits of
  ``test_torch_train_step.py``). ``olmoe-1b-7b`` routes in 2 groups on
  every side (the groups follow the data ways; capacity is per group).
- The wire-compressed step on (2, 2), ``init_state(grad_shards=2)``,
  against the reference's ``make_train_step(mesh=)``: loss 1e-5, after
  three steps params/``w32``/``m``/``v`` 1e-3 and ``err`` element by
  element (within 1e-3 of a level, or one level apart at under 5 % of a
  leaf); over six steps within 0.02 relative L2 of the port's exact step
  at the reference's own settings for that check (lr 1e-3, two rows a
  data group);
  int8 ``all_to_all`` and ``all_gather`` on the wire, and f32 only as
  scalar scales; and DTensor's own collectives (``CollectiveLog``) reduce
  nothing larger than a scalar over ``data``, where the exact step's
  gradient reduction shows.
- On a (1, 1) mesh (one rank) the exact step and the eval step are the
  one-device ones bit for bit.
- The eval step on (2, 2) within 1e-5 of the one-device eval, and the
  kernels' local-shard dispatch (``kernels/mesh.py``) with the plain
  versions as kernels: equal to the unsharded result, a redistribute
  counted only where the layout split a dim the kernel reduces over.
- Sharded checkpoints: a save from four ranks holding the state as
  DTensors on (2, 2) writes the reference's files byte for byte (same
  MANIFEST), and the reference's save under a (4, 2) mesh restores onto
  (2, 2) DTensors bitwise.
"""
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data import DataPipeline as JPipe
from repro.dist.checkpoint import CheckpointManager as JCkpt
from repro.dist.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.dist.sharding import ShardingCtx as JCtx
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.optim import optimizer as topt
from repro_torch.train.train_step import make_eval_step, make_train_step
from repro_torch.utils.tree import tree_leaves
from test_torch_mesh_ranks import (ARCHS, OPT, STEPS, TRACK_BATCH,
                                   TRACK_STEPS, _params, start_jax,
                                   start_job, wait_all)

B, S = 4, 16


class FakeMesh:
    def __init__(self, axes, shape):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _np_params(arch):
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_model(j_get_config(arch, reduced=True),
                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    blocks = np_params["blocks"]
    for sub, name in ((blocks, "ln1"), (blocks, "ln2"),
                      (np_params, "final_norm")):
        w = sub[name]
        sub[name] = (1.0 + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)
    return np_params


def _jax_state(np_params, arch=ARCHS[0]):
    p = jax.tree_util.tree_map(jnp.asarray, np_params)
    return {"params": p, "opt": jopt.init_state(p, jopt.AdamWConfig(**OPT))}


def _jax_side(io_dir):
    """The reference's results on a 4-device mesh (run in a subprocess)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.dist.collectives import _quantize_int8, make_compressed_psum
    from repro.dist.sharding import tree_shardings, use_sharding
    from repro.launch.mesh import make_mesh
    from repro.train.train_step import make_train_step as j_step
    from repro.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    mesh4 = make_mesh((4,), ("data",))
    f = jax.jit(make_compressed_psum(mesh4, "data"))
    err = jnp.zeros(inp["psum_x"].shape, jnp.float32)
    out["psum"] = []
    for x in inp["psum_x"], inp["psum_x2"]:
        qs = [jax.jit(_quantize_int8)(jnp.asarray(x[r]) + err[r])
              for r in range(4)]
        s, err = f(jnp.asarray(x), err)
        out["psum"].append({"sum": np.asarray(s), "err": np.asarray(err),
                            "q": [np.asarray(q) for q, _, _ in qs],
                            "scale": [float(c) for _, c, _ in qs]})

    mesh = make_mesh((2, 2), ("data", "model"))
    bsh = NamedSharding(mesh, P("data"))

    def run(arch, opt, batches, **kw):
        cfg = j_get_config(arch, reduced=True)
        params = jax.tree_util.tree_map(jnp.asarray, inp["params"][arch])
        sh = tree_shardings(pspec.logical_axes(japi.model_specs(cfg)),
                            mesh, J_TRAIN_RULES, params)
        params = jax.device_put(params, sh)
        state = jopt.init_state(params, opt, **kw.pop("state_kw", {}))
        step = jax.jit(j_step(cfg, opt, remat=True, **kw))
        metrics = []
        with use_sharding(mesh, J_TRAIN_RULES):
            for b in batches:
                b = {k: jax.device_put(jnp.asarray(v), bsh)
                     for k, v in b.items()}
                params, state, m = step(params, state, b)
                metrics.append({k: float(v) for k, v in m.items()})
        lv = jax.tree_util.tree_leaves
        return {"metrics": metrics,
                "params": [np.asarray(x) for x in lv(params)],
                "state": {k: [np.asarray(x) for x in lv(state[k])]
                          for k in state if k != "step"}}

    opt = jopt.AdamWConfig(**OPT)
    for arch in ARCHS:
        kw = {"num_groups": 2} if arch == "olmoe-1b-7b" else {}
        out[arch] = run(arch, opt, inp["batches"][arch], **kw)
    opt_c = jopt.AdamWConfig(compress_grads=True, **OPT)
    out["compressed"] = run(ARCHS[0], opt_c, inp["batches"][ARCHS[0]],
                            mesh=mesh, state_kw={"grad_shards": 2})

    cfg = j_get_config(ARCHS[0], reduced=True)
    state = jax.device_put(
        _jax_state(inp["params"][ARCHS[0]]),
        tree_shardings(jlaunch._build_state_axes(cfg, opt), mesh,
                       J_TRAIN_RULES))
    JCkpt(os.path.join(io_dir, "ck_jax22"), keep=2).save(
        state, 7, ctx=JCtx(mesh, J_TRAIN_RULES),
        axes=jlaunch._build_state_axes(cfg, opt))
    with open(os.path.join(io_dir, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)


def _inputs(io_dir):
    rng = np.random.default_rng(0)
    params = {a: _np_params(a) for a in ARCHS}
    batches = {}
    for a in ARCHS:
        pipe = JPipe(j_get_config(a, reduced=True), seq_len=S, global_batch=B)
        batches[a] = [pipe(i) for i in range(STEPS)]
    pipe = JPipe(j_get_config(ARCHS[0], reduced=True), seq_len=S,
                 global_batch=TRACK_BATCH)
    track_batches = [pipe(i) for i in range(TRACK_STEPS)]
    cfg = j_get_config(ARCHS[0], reduced=True)
    opt = jopt.AdamWConfig(**OPT)
    ck42 = os.path.join(io_dir, "ck_jax42")
    JCkpt(ck42, keep=2).save(
        _jax_state(params[ARCHS[0]]), 5,
        ctx=JCtx(FakeMesh(("data", "model"), (4, 2)), J_TRAIN_RULES),
        axes=jlaunch._build_state_axes(cfg, opt))
    inp = {"params": params, "batches": batches,
           "track_batches": track_batches, "ck_jax42": ck42,
           "psum_x": rng.standard_normal((4, 128)).astype(np.float32),
           "psum_x2": rng.standard_normal((4, 128)).astype(np.float32)}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("mesh_steps"))
    inp = _inputs(io_dir)
    wait_all(io_dir, [
        start_job("steps", io_dir), start_job("one", io_dir),
        start_jax("from test_torch_mesh_steps import _jax_side; "
                  f"_jax_side({io_dir!r})", io_dir, devices=4)])
    with open(os.path.join(io_dir, "steps.pkl"), "rb") as f:
        port = pickle.load(f)
    with open(os.path.join(io_dir, "one.pkl"), "rb") as f:
        port["one"] = pickle.load(f)
    with open(os.path.join(io_dir, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    return {"port": port, "jax": ref, "inp": inp, "dir": io_dir}


def _rel_close(out, ref, rel, what=""):
    """||out - ref|| <= rel * ||ref|| (L2; a scalar's relative gap)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    gap = np.linalg.norm((out - ref).ravel())
    assert gap <= rel * max(np.linalg.norm(ref.ravel()), 1e-30), (what, gap)


def _metrics_close(out, ref):
    for tm, jm in zip(out, ref, strict=True):
        _rel_close(tm["loss"], jm["loss"], 1e-5, "loss")
        _rel_close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
        _rel_close(tm["lr"], jm["lr"], 1e-6, "lr")


def _leaves_close(out, ref, rel, what):
    assert len(out) == len(ref)
    for i, (a, b) in enumerate(zip(out, ref)):
        _rel_close(a, b, rel, (what, i))


# --- make_compressed_psum ------------------------------------------------------

@pytest.mark.parametrize("rnd", [0, 1])
def test_compressed_psum_matches_jax(runs, rnd):
    port, ref = runs["port"]["psum"][rnd], runs["jax"]["psum"][rnd]
    # rank 0's row: its levels and scale bitwise; the reduction in its row
    np.testing.assert_array_equal(port["q"][0], ref["q"][0])
    assert port["scale"] == ref["scale"][0]
    np.testing.assert_array_equal(port["err"][0], ref["err"][0])
    _rel_close(port["sum"][0], ref["sum"][0], 1e-6, "sum")
    # the levels go out as int8, the scale as one f32
    assert port["wire"] == {("all_gather", "int8"): 128,
                            ("all_gather", "float32"): 4}


# --- the exact mesh step -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_exact_mesh_step_matches_jax(runs, arch):
    port, ref = runs["port"][arch], runs["jax"][arch]
    _metrics_close(port["metrics"], ref["metrics"])
    assert port["step"] == STEPS
    _leaves_close(port["params"], ref["params"], 1e-5, "params")
    for k in ("w32", "m", "v"):
        _leaves_close(port["state"][k], ref["state"][k], 1e-5, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_mesh_step_matches_one_device(runs, arch):
    cfg = get_config(arch, reduced=True)
    opt = topt.AdamWConfig(**OPT)
    params = _params(cfg, runs["inp"]["params"][arch])
    state = topt.init_state(params, opt)
    fw = {"num_groups": 2} if cfg.family == "moe" else {}
    step = make_train_step(cfg, opt, remat=True, **fw)
    metrics = []
    for b in runs["inp"]["batches"][arch]:
        params, state, m = step(params, state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    port = runs["port"][arch]
    _metrics_close(port["metrics"], metrics)
    _leaves_close(port["params"], [p.numpy() for p in tree_leaves(params)],
                  1e-5, "params")
    for k in ("w32", "m", "v"):
        _leaves_close(port["state"][k],
                      [x.numpy() for x in tree_leaves(state[k])], 1e-5, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_bitwise_the_one_device_step(runs, arch):
    """On a (1, 1) mesh the exact step's metrics and parameters after three
    steps, and the eval step's loss, are the one-device step's bit for
    bit: the vocab-parallel lookup and loss add no rounding of their own
    (the loss takes ``torch.logsumexp``'s formula and backward)."""
    one, mesh = runs["port"]["one"][arch]["one"], \
        runs["port"]["one"][arch]["mesh"]
    assert mesh["metrics"] == one["metrics"]
    assert mesh["eval"] == one["eval"]
    for a, b in zip(mesh["params"], one["params"], strict=True):
        assert np.array_equal(a, b)


# --- the wire-compressed step -------------------------------------------------

def _err_gaps_are_level_flips(ref, out):
    """Each residual element equals the reference's within 1e-3 of a level
    (a level is about twice the leaf's largest residual), or differs by
    about one level, at no more than 5 % of a leaf's elements."""
    for i, (a, b) in enumerate(zip(ref, out, strict=True)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        level = 2.0 * np.abs(a).max()
        gap = np.abs(a - b)
        flips = gap > 1e-3 * level
        assert flips.mean() <= 0.05, (i, flips.mean())
        assert (gap <= 1.05 * level).all(), (i, gap.max() / level)


def test_compressed_step_matches_jax(runs):
    port, ref = runs["port"]["compressed"]["c"], runs["jax"]["compressed"]
    for tm, jm in zip(port["metrics"], ref["metrics"], strict=True):
        _rel_close(tm["loss"], jm["loss"], 1e-5, "loss")
        _rel_close(tm["lr"], jm["lr"], 1e-6, "lr")
    _leaves_close(port["params"], ref["params"], 1e-3, "params")
    for k in ("w32", "m", "v"):
        _leaves_close(port["state"][k], ref["state"][k], 1e-3, k)
    _err_gaps_are_level_flips(ref["state"]["err"], port["state"]["err"])


def test_compressed_step_tracks_exact_step(runs):
    c = runs["port"]["compressed"]["track_c"]
    e = runs["port"]["compressed"]["track_e"]
    assert len(c["metrics"]) == TRACK_STEPS
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(c["params"],
                                                          e["params"]))
    den = sum(float(np.sum(b ** 2)) for b in e["params"])
    assert (num / den) ** 0.5 < 0.02, (num / den) ** 0.5


def test_compressed_step_moves_int8(runs):
    """What this rank handed to the wire in each step: int8 levels by
    all_to_all (phase 1) and all_gather (phase 2), each about a byte a
    parameter of its model shard; f32 only as scalar scales (a few a
    leaf); no f32 all-reduce of a gradient. The exact step hands nothing
    to these collectives."""
    port = runs["port"]["compressed"]
    n_leaves = len(port["c"]["params"])
    for wire in port["c"]["wire"] + port["track_c"]["wire"]:
        assert set(wire) <= {("all_to_all", "int8"), ("all_gather", "int8"),
                             ("all_gather", "float32"),
                             ("all_reduce_max", "float32")}, wire
        assert wire[("all_gather", "int8")] * 2 == \
            wire[("all_to_all", "int8")]
        f32 = sum(v for (op, dt), v in wire.items() if dt == "float32")
        assert 0 < f32 <= 4 * 4 * n_leaves
    # a byte a parameter of this rank's model shard (half of each leaf
    # split on model, the replicated leaves whole), chunk-padded
    total = sum(p.size for p in port["c"]["params"])
    a2a = port["c"]["wire"][0][("all_to_all", "int8")]
    assert total / 2 < a2a < total
    assert all(w == {} for w in port["track_e"]["wire"])


def test_compressed_step_reduces_no_gradient_over_data(runs):
    """DTensor's own collectives in each step (``CollectiveLog``), which
    the wire counter does not see: over ``data`` the compressed step runs
    no ``all_reduce`` or ``reduce_scatter`` of more than one element (the
    mean loss is the one scalar), while its TP reductions over ``model``
    run. The exact step's gradient reduction over ``data`` shows in the
    same log, so the log sees such a reduction where one runs."""
    port = runs["port"]["compressed"]
    for d in port["c"]["dtensor"] + port["track_c"]["dtensor"]:
        assert d["data"] <= 1, d["counts"]
        assert d["model"] > 1, d["counts"]
    n_max = max(p.size for p in port["track_e"]["params"])
    for d in port["track_e"]["dtensor"]:
        assert d["data"] > 1, d["counts"]
        assert d["data"] <= n_max


# --- the eval step and the kernels' local shards --------------------------------

def test_mesh_eval_step_matches_one_device(runs):
    cfg = get_config(ARCHS[0], reduced=True).replace(use_kernels=True)
    params = _params(cfg, runs["inp"]["params"][ARCHS[0]])
    ref = float(make_eval_step(cfg)(params, runs["inp"]["batches"][
        ARCHS[0]][0]))
    _rel_close(runs["port"]["eval_loss"], ref, 1e-5, "eval loss")


@pytest.mark.parametrize("case,moved", [
    ("rows", 0), ("rows_and_width", 1), ("heads", 0), ("kv_replicated", 1),
    ("head_dim", 3)])
def test_kernel_runs_on_local_shards(runs, case, moved):
    out, n = runs["port"]["kernels"][case]
    np.testing.assert_allclose(out, runs["port"]["kernel_refs"][case],
                               rtol=1e-6, atol=1e-6)
    assert n == moved


# --- sharded checkpoints ------------------------------------------------------

def _step_files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_sharded_save_from_ranks_matches_jax(runs):
    port = _step_files(os.path.join(runs["dir"], "ck_port22",
                                    "step_00000007"))
    ref = _step_files(os.path.join(runs["dir"], "ck_jax22",
                                   "step_00000007"))
    assert sorted(port) == sorted(ref)
    assert json.loads(port.pop("MANIFEST")) == json.loads(ref.pop("MANIFEST"))
    assert port == ref
    assert any(".shard_003." in f for f in port)  # a real 2 x 2 grid


def test_restore_onto_another_mesh_bitwise(runs):
    port = runs["port"]
    assert port["restored_step"] == 5
    assert port["restored_kinds"] == ["DTensor", "Tensor"]
    ref = jax.tree_util.tree_leaves(
        _jax_state(runs["inp"]["params"][ARCHS[0]]))
    assert len(ref) == len(port["restored"])
    for a, b in zip(port["restored"], ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_torch_dtype_of_restored_state(runs):
    """The restored state keeps the template's dtypes (f32 leaves, the
    int32 step)."""
    kinds = {str(a.dtype) for a in runs["port"]["restored"]}
    assert kinds == {"float32", "int32"}
