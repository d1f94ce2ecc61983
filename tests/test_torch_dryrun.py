"""The port's production-mesh dry run (``repro_torch.launch.{specs,
hlo_analysis,dryrun}``) against the reference's (``repro.launch``): the
counterparts of ``tests/test_dryrun_small.py`` and of the
``hlo_analysis`` satellites of ``tests/test_analysis.py``.

* the shape cells and their skip decisions are the reference's;
* per-rank parameter, optimizer, cache and carry bytes of every cell of
  ``ALL_CELLS``, pod and multi-pod, at full width, equal the reference's
  shardings (``repro.dist.sharding`` pspecs and the mesh sizes): the
  port's side is each cell's state as the cell runs with it
  (``dryrun.lm_state`` / ``chords_state``: fake DTensors on the
  production mesh), built without running a step;
* small cells built and run on fake tensors over a fake process group of
  512 ranks, in a subprocess (``python tests/test_torch_dryrun.py OUT``,
  which also builds the states above), so that no process group is left
  in the test worker: a reduced
  ``internlm2-1.8b`` train cell on (2, 2) under ``TRAIN_RULES``, prefill
  and decode cells, the CHORDS roll over an 8-way ``data`` axis, the slot
  grid on (4, 2), the ``compressed`` variant, one sharded matmul's FLOPs,
  the production meshes, reduced xLSTM with 4 heads over 16 model ranks
  (local blocks in other strides than their global views') and reduced
  zamba2's decode cell on (2, 2) with one SSD layer's census by hand.

Already covered elsewhere, not repeated: the compressed psum against the
exact sum (``tests/test_torch_mesh_ranks.py`` job ``psum``), the rule
tables and every leaf's pspec (``tests/test_torch_mesh_specs.py``).
"""
import ast
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


def _ref_literal(name):
    """A top-level literal of the reference's ``launch/dryrun.py``, read
    without importing it (it sets ``XLA_FLAGS`` on import)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                any(getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


# --- shapes --------------------------------------------------------------------

def test_shapes_are_the_references():
    from repro.configs import base as jb
    from repro_torch.configs import base as tb

    assert {k: dataclasses.asdict(v) for k, v in tb.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jb.SHAPES.items()}
    assert tb.SUB_QUADRATIC_FAMILIES == jb.SUB_QUADRATIC_FAMILIES
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(tb, name)) == \
            dataclasses.asdict(getattr(jb, name))


def _archs():
    from repro_torch.configs import list_archs

    return list_archs()


@pytest.mark.parametrize("arch", _archs())
def test_shape_applicable_is_the_references(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.configs import shape_applicable as japp
    from repro_torch.configs import SHAPES, get_config, shape_applicable

    for name, shape in SHAPES.items():
        assert shape_applicable(get_config(arch), shape) == \
            japp(jget(arch), JSHAPES[name]), (arch, name)


def test_cells_are_the_references():
    from repro.configs import ASSIGNED_ARCHS
    from repro_torch.launch import dryrun as D

    want = [(a, s) for a in ASSIGNED_ARCHS for s in
            ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
        ("chords-dit-xl", "chords_image"), ("chords-dit-xl", "chords_video")]
    assert D.ALL_CELLS == want
    assert D.CHORDS_SHAPES == _ref_literal("CHORDS_SHAPES")
    assert D.DEFAULT_MICROBATCH == _ref_literal("DEFAULT_MICROBATCH")


# --- per-rank bytes at full width, the reference's side ---------------------

def _ref_layout_bytes(structs, axes, ctx, mesh, skip=()):
    import jax

    total = 0
    flat_ax = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_st = dict(jax.tree_util.tree_flatten_with_path(structs)[0])
    for path, ax in flat_ax:
        if path[-1].key in skip:
            continue
        st = flat_st[path]
        n = st.dtype.itemsize
        for d, e in zip(st.shape, tuple(ctx.pspec(ax, st.shape))
                        + (None,) * len(st.shape)):
            names = () if e is None else (e,) if isinstance(e, str) else e
            n *= int(d) // math.prod(mesh.shape[a] for a in names)
        total += n
    return total


def _ref_cell_bytes(arch, shape_name, multi_pod):
    """The reference's per-rank bytes of a cell: its structs laid out by
    ``repro.dist.sharding`` on the production mesh's sizes."""
    import jax.numpy as jnp

    from repro.configs import SHAPES, get_config, shape_applicable
    from repro.dist import sharding as jsh
    from repro.launch import specs as JS
    from repro.optim.optimizer import AdamWConfig

    mesh = FakeMesh(("pod", "data", "model"), (2, 16, 16)) if multi_pod \
        else FakeMesh(("data", "model"), (16, 16))
    cfg = get_config(arch)
    chords = _ref_literal("CHORDS_SHAPES")
    if shape_name in chords:
        import jax

        from repro.diffusion.wrapper import wrapper_specs
        from repro.utils import pspec

        s_, k, b, seq, ld = chords[shape_name]
        ctx = jsh.ShardingCtx(mesh, jsh.SERVE_RULES)
        ws = wrapper_specs(cfg, ld)
        lat = jax.ShapeDtypeStruct((s_, k, b, seq, ld), jnp.float32)
        lax = ("slots", "cores", "batch", "seq", None)
        carry = {"x": lat, "x_snap": lat, "f_snap": lat, "finals": lat,
                 "p": jax.ShapeDtypeStruct((s_, k), jnp.int32)}
        cax = {"x": lax, "x_snap": lax, "f_snap": lax, "finals": lax,
               "p": ("slots", "cores")}
        return {"params": _ref_layout_bytes(
                    pspec.param_structs(ws, jnp.bfloat16),
                    pspec.logical_axes(ws), ctx, mesh),
                "carry": _ref_layout_bytes(carry, cax, ctx, mesh)}
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"skipped": True, "reason": why}
    rules = jsh.TRAIN_RULES if shape.kind == "train" else jsh.SERVE_RULES
    ctx = jsh.ShardingCtx(mesh, rules)
    ps, pax = JS.model_structs(cfg)
    out = {"params": _ref_layout_bytes(ps, pax, ctx, mesh)}
    if shape.kind == "train":
        os_, oax = JS.opt_structs(cfg, AdamWConfig())
        out["opt"] = _ref_layout_bytes(os_, oax, ctx, mesh)
    if shape.kind == "decode":
        cs, cax = JS.cache_structs(cfg, shape)
        out["cache"] = _ref_layout_bytes(cs, cax, ctx, mesh, skip=("len",))
    return out


def _cells():
    from repro_torch.launch.dryrun import ALL_CELLS

    return [(a, s, mp) for a, s in ALL_CELLS for mp in (False, True)]


def _cell_key(arch, shape, multi_pod):
    return f"{arch}|{shape}|{'multipod' if multi_pod else 'pod'}"


# --- the analysis helpers (the reference's hlo_analysis satellites) ----------

def test_roofline_is_the_cards():
    from repro_torch.launch import hlo_analysis as H

    assert (H.PEAK_FLOPS, H.HBM_BW, H.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert "H100" in H.CARD and "700 W" in H.CARD
    t = H.roofline_terms(989e12, 3.35e12 / 2, 450e9 / 4, 3.35e12 / 8)
    assert t["bottleneck"] == "compute" and t["bound_s"] == 1.0
    assert t["t_memory_s"] == 0.5 and t["t_collective_s"] == 0.25
    assert t["t_memory_min_s"] == 0.125
    assert t["bottleneck_eager"] == "compute"
    # the bottleneck is named from lower bounds only: eager bytes above
    # the compute term leave it at compute, and say so beside it
    t = H.roofline_terms(989e12, 3.35e12 * 2, 0.0, 3.35e12 / 2)
    assert (t["bottleneck"], t["bound_s"]) == ("compute", 1.0)
    assert t["bottleneck_eager"] == "memory" and t["t_memory_s"] == 2.0
    t = H.roofline_terms(989e12, 3.35e12 * 4, 0.0, 3.35e12 * 3)
    assert (t["bottleneck"], t["bound_s"]) == ("memory", 3.0)
    # none of the reference's TPU figures (197 TFLOP/s, 819 GB/s, 50 GB/s)
    figures = {v for v in vars(H).values() if isinstance(v, float)}
    assert not figures & {197e12, 819e9, 50e9}


def test_collective_bytes_follow_the_references_convention():
    from repro_torch.launch import hlo_analysis as H

    dtensor = {("all-reduce", "model", "bfloat16"): [2, 100],
               ("all-gather", "data", "bfloat16"): [1, 64]}
    # WIRE_GROUPS: bytes sent; an all-gather counts its gathered result
    wire = H.wire_census({("all_gather", "g_data", "int8"): [1, 10, 4],
                          ("all_to_all", "g_data", "int8"): [1, 12, 4],
                          ("permute", "g_model", "float32"): [3, 30, 2]},
                         {"g_data": "data", "g_model": "model"})
    assert wire == {("all-gather", "data", "int8"): [1, 40],
                    ("all-to-all", "data", "int8"): [1, 12],
                    ("collective-permute", "model", "float32"): [3, 30]}
    cb = H.collective_bytes(dtensor, wire)
    assert cb["all-reduce"] == 200.0  # twice, as the reference's _MULT
    assert cb["all-gather"] == 104.0 and cb["all-to-all"] == 12.0
    assert cb["collective-permute"] == 30.0
    assert cb["total"] == 346.0 and cb["num_ops"] == 8
    assert {(e["op"], e["axis"], e["dtype"]) for e in cb["by_axis"]} == \
        set(dtensor) | set(wire)


def test_entry_shapes_and_replicated_params():
    import torch

    from repro_torch.launch import hlo_analysis as H

    tree = {"p0": torch.zeros(2, 4, 8), "p1": torch.zeros(8, 4, 8),
            "p2": torch.zeros(8)}
    assert H.entry_param_shapes(tree) == [
        ("p0", "float32", [2, 4, 8]), ("p1", "float32", [8, 4, 8]),
        ("p2", "float32", [8])]
    assert H.find_param_shape(tree, (8, 4, 8)) == [
        ("p0", [2, 4, 8]), ("p1", [8, 4, 8])]
    # global [8,4,8]: p0 is the 8/4-way shard (fine), p1 full (replicated)
    hits = H.replicated_entry_params(tree, [(8, 4, 8)], min_bytes=128)
    assert [(n, tuple(d)) for n, d, _ in hits] == [("p1", (8, 4, 8))]
    assert H.replicated_entry_params(tree, [(8,)], min_bytes=128) == []


# --- small cells on a fake process group (one subprocess) --------------------

def _run_jobs(out):
    """The subprocess: every small cell, its record written to ``out``."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.chords import ChordsCarry, make_round_body
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.dist import collectives as coll
    from repro_torch.dist.sharding import (SERVE_RULES, ShardingCtx,
                                           use_sharding)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import mamba2

    D.init_fake_world(512)
    res = {"meshes": [[list(m.shape), list(m.mesh_dim_names)] for m in (
        make_production_mesh(device="cpu"),
        make_production_mesh(multi_pod=True, device="cpu"))]}
    m22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    m42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    m8 = make_mesh((8,), ("data",), device="cpu")

    res["train"] = D.build_lm_cell(get_config("internlm2-1.8b",
                                              reduced=True),
                                   ShapeConfig("t", 32, 4, "train"), m22, 2)
    q = get_config("qwen1.5-0.5b", reduced=True)
    res["prefill"] = D.build_lm_cell(q, ShapeConfig("p", 32, 4, "prefill"),
                                     m22)
    res["decode"] = D.build_lm_cell(q, ShapeConfig("d", 64, 4, "decode"),
                                    m22)
    res["compressed"] = D.build_lm_cell(
        q, ShapeConfig("t", 16, 8, "train"), m42, 1, variant="compressed")
    dit = get_config("chords-dit-xl", reduced=True)
    res["slots"] = D.build_chords_cell(dit, "chords_image", m42,
                                       dims=(8, 4, 1, 16, 8), n_steps=20)

    # the CHORDS roll: 8 cores over an 8-way data axis (each rank one core)
    tr = D.CellTrace(m8)
    k, n = 8, 20
    with tr.fake_mode:
        def lat(shape, dtype=torch.float32):
            return DTensor.from_local(
                torch.empty((1,) + shape[1:], dtype=dtype), m8, [Shard(0)],
                run_check=False, shape=shape,
                stride=tuple(math.prod(shape[i + 1:])
                             for i in range(len(shape))))
        x = lat((k, 64))
        carry = ChordsCarry(x=x, x_snap=lat((k, 64)), f_snap=lat((k, 64)),
                            p=lat((k,), torch.int32), finals=lat((k, 64)))
        tgrid = tr.fake_mode.from_tensor(uniform_tgrid(n))
    body = make_round_body(lambda x_, t: -x_ * t[:, None], tgrid,
                           [0, 2, 4, 6, 8, 10, 12, 14], n, k)
    with use_sharding(m8, SERVE_RULES), tr.run(carry):
        new, _ = body(carry, 3)
    res["roll"] = {
        "census": H.collective_bytes(tr.counter.collectives, H.wire_census(
            tr.wire, H.group_axes(m8))),
        "out": [H.local_shape(t) for t in new]}

    # DTensor viewed local blocks in other strides than their global
    # view's: reduced xLSTM with the full width's 4 heads over 16 model
    # ranks and chunks of 32 (the prefill_32k / train_4k fault)
    xl = get_config("xlstm-1.3b", reduced=True).replace(num_heads=4,
                                                        ssm_chunk=32)
    m216 = make_mesh((2, 16), ("data", "model"), device="cpu")
    res["xlstm_views"] = [D.build_lm_cell(
        xl, ShapeConfig(kind[0], 64, 4, kind), m216)["kind"]
        for kind in ("prefill", "train")]

    # reduced zamba2's decode cell on (2, 2), and one SSD layer's decode
    # step alone on the cell's own state (its 8 heads, 4 a model rank)
    z = get_config("zamba2-2.7b", reduced=True)
    zs = ShapeConfig("d", 64, 4, "decode")
    res["zamba2_decode"] = D.build_lm_cell(z, zs, m22)["per_device"][
        "collective_bytes"]
    tr = D.CellTrace(m22)
    ctx = ShardingCtx(m22, SERVE_RULES)
    with tr.fake_mode:
        st = D.lm_state(z, zs, ctx, "cpu")
        x = D.fake_tree({"x": S.TensorStruct((4, 1, z.d_model),
                                             torch.float32)},
                        {"x": ("batch", "seq", "embed_act")}, ctx,
                        "cpu")["x"]
    ssd = {k: v[0] for k, v in st["params"]["mamba"]["ssd"].items()}
    with use_sharding(m22, SERVE_RULES), tr.run((ssd, x)):
        mamba2.ssd_decode_step(ssd, z, x, st["cache"]["conv"][0],
                               st["cache"]["ssm"][0])
    res["ssd_layer"] = H.collective_bytes(tr.counter.collectives)

    # reduced zamba2's long_500k cell in small: batch 1 on (8, 2), so that
    # ``data`` falls back to the caches' kv_seq (8 of 64 positions a rank)
    m82 = make_mesh((8, 2), ("data", "model"), device="cpu")
    res["zamba2_long"] = D.build_lm_cell(
        z, ShapeConfig("l", 64, 1, "decode"), m82)

    # one sharded matmul: [64, 128] rows on data @ [128, 256] cols on model
    tr = D.CellTrace(m22)
    with tr.fake_mode:
        a = DTensor.from_local(torch.empty(32, 128), m22,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(64, 128), stride=(128, 1))
        w = DTensor.from_local(torch.empty(128, 128), m22,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(128, 256), stride=(256, 1))
    with tr.run((a, w)):
        y = a @ w
    res["matmul"] = {"flops": tr.counter.flops, "local": H.local_shape(y),
                     "global": list(y.shape)}
    coll.reset_wire_bytes()
    res["state_bytes"] = _state_bytes()
    with open(out, "w") as f:
        json.dump(res, f)


def _state_bytes():
    """Per-rank bytes of every cell's state at full width, pod and
    multi-pod: the fake DTensors each cell runs with, built on the
    production mesh without running a step (inside the 512-rank group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.dist.sharding import SERVE_RULES, ShardingCtx
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    meshes = {mp: make_production_mesh(multi_pod=mp, device="cpu")
              for mp in (False, True)}
    out = {}
    for arch, shape_name, mp in _cells():
        cfg, mesh = get_config(arch), meshes[mp]
        with FakeTensorMode(allow_non_fake_inputs=True):
            if shape_name in D.CHORDS_SHAPES:
                st = D.chords_state(cfg, D.CHORDS_SHAPES[shape_name],
                                    ShardingCtx(mesh, SERVE_RULES), "cpu")
            else:
                shape = SHAPES[shape_name]
                ok, why = shape_applicable(cfg, shape)
                if not ok:
                    out[_cell_key(arch, shape_name, mp)] = {
                        "skipped": True, "reason": why}
                    continue
                st = D.lm_state(cfg, shape, ShardingCtx(
                    mesh, D.cell_rules(shape.kind)), "cpu")
        out[_cell_key(arch, shape_name, mp)] = D.state_bytes(st)
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "jobs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(out.read_text())


def _ops(census, op=None, axis=None, dtype=None):
    return [e for e in census["by_axis"]
            if (op is None or e["op"] == op)
            and (axis is None or e["axis"] == axis)
            and (dtype is None or e["dtype"] == dtype)]


REF_KEYS = ("arch shape kind mesh axes chips per_device global_flops "
            "model_flops n_params useful_flops_ratio roofline "
            "memory_analysis").split()


@pytest.mark.parametrize("arch,shape,multi_pod", _cells(),
                         ids=lambda v: v if isinstance(v, str)
                         else ("multipod" if v else "pod"))
def test_cell_bytes_equal_the_references(jobs, arch, shape, multi_pod):
    got = jobs["state_bytes"][_cell_key(arch, shape, multi_pod)]
    assert got == _ref_cell_bytes(arch, shape, multi_pod)
    if not got.get("skipped"):
        assert all(v > 0 for v in got.values())


def test_production_meshes(jobs):
    assert jobs["meshes"] == [[[16, 16], ["data", "model"]],
                              [[2, 16, 16], ["pod", "data", "model"]]]


def _ref_small_bytes(arch, shape, kind, sizes):
    """The reference's per-rank bytes of a reduced cell on a small mesh."""
    from repro.configs import ShapeConfig, get_config
    from repro.dist import sharding as jsh
    from repro.launch import specs as JS
    from repro.optim.optimizer import AdamWConfig

    mesh = FakeMesh(("data", "model"), sizes)
    cfg = get_config(arch, reduced=True)
    rules = jsh.TRAIN_RULES if kind == "train" else jsh.SERVE_RULES
    ctx = jsh.ShardingCtx(mesh, rules)
    ps, pax = JS.model_structs(cfg)
    out = {"params": _ref_layout_bytes(ps, pax, ctx, mesh)}
    sh = ShapeConfig("s", shape[1], shape[0], kind)
    if kind == "train":
        os_, oax = JS.opt_structs(cfg, AdamWConfig())
        out["opt"] = _ref_layout_bytes(os_, oax, ctx, mesh)
    if kind == "decode":
        cs, cax = JS.cache_structs(cfg, sh)
        out["cache"] = _ref_layout_bytes(cs, cax, ctx, mesh, skip=("len",))
    return out


def test_small_train_cell_builds_on_2x2(jobs):
    from repro_torch.launch.hlo_analysis import HBM_BW

    r = jobs["train"]
    assert set(REF_KEYS) <= set(r)
    assert r["kind"] == "train" and r["mesh"] == [2, 2] and r["chips"] == 4
    assert r["bytes"] == _ref_small_bytes("internlm2-1.8b", (4, 32),
                                          "train", (2, 2))
    pd = r["per_device"]
    assert pd["flops"] > 0 and pd["hbm_bytes"] > 0 and pd["traced_ops"] > 0
    assert r["global_flops"] == pd["flops"] * 4
    ma = r["memory_analysis"]
    assert ma["eager_peak_bytes"] >= ma["argument_size_in_bytes"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    assert r["roofline"]["t_memory_min_s"] == (
        ma["argument_size_in_bytes"] + ma["output_size_in_bytes"]) / HBM_BW
    # TRAIN_RULES: FSDP gathers of the parameters over data
    assert _ops(pd["collective_bytes"], "all-gather", "data")


def test_small_prefill_and_decode_cells(jobs):
    p, d = jobs["prefill"], jobs["decode"]
    assert p["kind"] == "prefill" and d["kind"] == "decode"
    assert p["bytes"]["params"] == d["bytes"]["params"] == \
        _ref_small_bytes("qwen1.5-0.5b", (4, 64), "decode",
                         (2, 2))["params"]
    # the decode cell's cache full to seq_len - 1, its last position written
    assert d["decode_position"] == 63
    assert d["bytes"]["cache"] == _ref_small_bytes(
        "qwen1.5-0.5b", (4, 64), "decode", (2, 2))["cache"]
    # the prefill's new cache: each rank holds its block only (the same
    # layout at 32 positions is half the decode cell's 64)
    assert p["bytes"]["cache_out"] == d["bytes"]["cache"] // 2
    assert d["per_device"]["flops"] < p["per_device"]["flops"]


def test_chords_roll_sends_one_boundary_slab(jobs):
    """The counterpart of the reference's collective-permute check: the
    roll over an 8-way data axis moves one core's slab a rank (64 f32),
    never a gather of the cores."""
    cen = jobs["roll"]["census"]
    perm = _ops(cen, "collective-permute", "data")
    assert perm and all(e["bytes"] <= 64 * 4 * e["launches"] for e in perm)
    assert any(e["bytes"] == 64 * 4 * e["launches"] for e in perm)
    assert not _ops(cen, "all-gather")
    assert all(s[0] == 1 for s in jobs["roll"]["out"])


def test_slot_grid_stays_slot_sharded(jobs):
    r = jobs["slots"]
    assert r["slot_shard_check"] == {"global": [8, 4, 1, 16, 8],
                                     "per_device": [2, 4, 1, 16, 8]}
    cen = r["per_device"]["collective_bytes"]
    assert not _ops(cen, "all-gather", "data"), cen["by_axis"]
    assert r["kind"] == "chords" and r["num_slots"] == 8


def test_slot_shard_check_raises_when_slots_are_whole():
    import torch

    from repro_torch.launch.dryrun import check_slot_shards

    whole = {"x": torch.zeros(8, 4, 1, 16, 8), "p": torch.zeros(8, 4)}
    part = {"x": torch.zeros(2, 4, 1, 16, 8), "p": torch.zeros(2, 4)}
    check_slot_shards({"entered": part, "left": part}, [2, 4, 1, 16, 8])
    for trees in ({"entered": whole, "left": part},
                  {"entered": part, "left": whole}, {"entered": {}}):
        with pytest.raises(RuntimeError, match="not sharded as intended"):
            check_slot_shards(trees, [2, 4, 1, 16, 8])


def test_compressed_variant_puts_int8_on_the_wire(jobs):
    cen = jobs["compressed"]["per_device"]["collective_bytes"]
    assert _ops(cen, "all-to-all", "data", "int8")
    assert _ops(cen, "all-gather", "data", "int8")
    # over data, f32 is all-reduced only as scalars (the global norm, the
    # loss; 4 bytes, twice), never a gradient
    assert all(e["bytes"] <= 8 * e["launches"]
               for e in _ops(cen, "all-reduce", "data", "float32"))


def test_xlstm_cells_with_views_of_strided_blocks_build(jobs):
    """Before ``sharding.conform``: ``Cannot view a tensor with shape
    [2, 4, 2, 32, 1] ...`` in the mLSTM's ``num`` product (prefill and
    train); without its gradients laid out as their forward tensors, the
    train step's backward: ``Cannot unflatten unevenly sharded tensor``
    (a sequence split over 16 ranks viewed as 2 chunks)."""
    assert jobs["xlstm_views"] == ["prefill", "train"]


def test_zamba2_decode_ssd_layer_bytes_are_the_hand_count(jobs):
    """One SSD layer's decode step by heads on (2, 2), reduced zamba2 in
    f32, a rank's 2 rows of one token and 4 of the 8 heads: the
    projection [2, 1, 296] and the conv output [2, 1, 160] gathered over
    ``model``, the sum of squares [2, 1, 1] and the output [2, 1, 64]
    all-reduced over it (each counted twice); nothing over ``data``, no
    parameter and no state gathered."""
    cen = jobs["ssd_layer"]
    f32 = 4
    assert {(e["op"], e["axis"], e["dtype"], e["launches"], e["bytes"])
            for e in cen["by_axis"]} == {
        ("all-gather", "model", "float32", 2, (296 + 160) * 2 * f32),
        ("all-reduce", "model", "float32", 2, 2 * (1 + 64) * 2 * f32)}
    # the whole cell (4 such layers, the shared block, the unembedding)
    whole = jobs["zamba2_decode"]
    assert whole["total"] >= 4 * cen["total"]
    assert not [e for e in whole["by_axis"] if e["axis"] == "data"]


def test_zamba2_long_decode_merges_the_softmax_over_data(jobs):
    """Reduced zamba2 at batch 1 on (8, 2) (the long_500k layout: the
    shared attention's KV cache split along its sequence over ``data``):
    over ``data`` the step only all-reduces the softmax merge, three f32
    tensors a shared-attention call of B·H·(Dh + 2)·4 B in all (B 1, H
    the rank's 2 of 4 heads, Dh 16; each all-reduce counted twice, as the
    reference counts it), to within 1 %; no gather of a (bf16) cache
    over any axis, and the cache's bytes a rank are the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.models.zamba2 import _groups

    r = jobs["zamba2_long"]
    cfg = get_config("zamba2-2.7b", reduced=True)
    cen = r["per_device"]["collective_bytes"]
    over_data = _ops(cen, axis="data")
    assert {(e["op"], e["dtype"]) for e in over_data} == {
        ("all-reduce", "float32")}
    assert not _ops(cen, "all-gather", dtype="bfloat16")  # the caches'
    calls = _groups(cfg)[0]
    merge = 1 * (cfg.num_heads // 2) * (cfg.resolved_head_dim + 2) * 4
    assert sum(e["launches"] for e in over_data) == 3 * calls
    got = sum(e["bytes"] for e in over_data) / 2
    assert abs(got - calls * merge) <= 0.01 * calls * merge
    assert r["bytes"]["cache"] == _ref_small_bytes(
        "zamba2-2.7b", (1, 64), "decode", (8, 2))["cache"]


def test_sharded_matmul_flops_are_the_hand_count(jobs):
    mm = jobs["matmul"]
    assert mm["global"] == [64, 256] and mm["local"] == [32, 128]
    assert mm["flops"] == 2 * 32 * 128 * 128  # this rank's product only


def test_cli_refuses_cuda_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA mesh can be built")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert not list(tmp_path.iterdir())


if __name__ == "__main__":
    _run_jobs(sys.argv[1])
