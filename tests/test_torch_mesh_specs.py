"""``repro_torch.dist.sharding`` against ``repro.dist.sharding``: the
partition spec and the checkpoint shard grid of every parameter leaf
(``model_specs``) and every cache leaf (``cache_axes``, at the reference's
``cache_specs`` shapes) of every registered config at full width (shapes
only, nothing allocated), under all four rule tables, on fake meshes
(2, 2), (4, 2), (16, 16) and (2, 16, 16): equal, exactly. Plus the
reference's own unit cases of the spec builder and the grid math
(``tests/test_dist.py::test_pspec_divisible_fallback``,
``tests/test_checkpoint_faults.py::test_shard_grid_math``) on the port,
``vmapped_axes`` reservations, and ``shard_act`` outside a context.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist import sharding as jsh
from repro.models import api as japi
from repro.utils import pspec as jpspec
from repro_torch.configs import get_config
from repro_torch.configs.base import list_archs
from repro_torch.dist import sharding as tsh
from repro_torch.models import api
from repro_torch.utils import pspec as tpspec

RULES = {"train": "TRAIN_RULES", "serve": "SERVE_RULES",
         "train_layers_fsdp": "TRAIN_LAYERS_FSDP_RULES",
         "serve_deep_tp": "SERVE_DEEP_TP_RULES"}
MESHES = [(("data", "model"), (2, 2)), (("data", "model"), (4, 2)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


class FakeMesh:
    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


def _axes_leaves(tree):
    out = []

    def walk(t, path):
        if isinstance(t, tuple):
            out.append((path, t))
        else:
            for k in sorted(t):
                walk(t[k], path + (k,))

    walk(tree, ())
    return out


def _leaves(arch):
    """[(name, logical axes, full-width shape)] of the params and caches."""
    jcfg = j_get_config(arch)
    specs = japi.model_specs(jcfg)
    shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), specs,
                                    is_leaf=jpspec.is_spec)
    out = []
    port_axes = dict(_axes_leaves(tpspec.logical_axes(
        api.model_specs(get_config(arch)))))
    for path, ax in _axes_leaves(jpspec.logical_axes(specs)):
        shape = shapes
        for k in path:
            shape = shape[k]
        assert port_axes[path] == ax, (path, port_axes[path], ax)
        out.append(("params/" + "/".join(path), ax, shape))
    jmod = japi.get_module(jcfg)
    if hasattr(jmod, "cache_axes"):
        tmod = api.get_module(get_config(arch))
        assert tmod.cache_axes(get_config(arch)) == jmod.cache_axes(jcfg)
        for batch, max_len in ((1, 32768), (8, 4096)):
            cs = jmod.cache_specs(jcfg, batch, max_len)
            for path, ax in _axes_leaves(jmod.cache_axes(jcfg)):
                leaf = cs
                for k in path:
                    leaf = leaf[k]
                out.append((f"cache{batch}/" + "/".join(path), ax,
                            tuple(leaf.shape)))
    return out


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", list_archs())
def test_pspec_and_grid_parity(arch, rules):
    jr, tr = getattr(jsh, RULES[rules]), getattr(tsh, RULES[rules])
    assert tr == jr
    leaves = _leaves(arch)
    assert leaves
    for axes, sizes in MESHES:
        mesh = FakeMesh(axes, sizes)
        jctx, tctx = jsh.ShardingCtx(mesh, jr), tsh.ShardingCtx(mesh, tr)
        for name, ax, shape in leaves:
            want = tuple(jctx.pspec(ax, shape))
            got = tctx.pspec(ax, shape)
            assert tuple(got) == want, (name, sizes, got, want)
            assert tctx.shard_spec(ax, shape) == jctx.shard_spec(ax, shape)
            # the DTensor layout of the spec: one placement a mesh dim
            pl = tsh.spec_placements(got, axes)
            assert sum(p.is_shard() for p in pl) == sum(
                len(tsh._as_tuple(e)) for e in got)


def test_fallbacks_and_tables_are_the_references():
    assert tsh.FALLBACKS == jsh.FALLBACKS
    for name in RULES.values():
        assert getattr(tsh, name) == getattr(jsh, name)


def test_pspec_divisible_fallback():
    ctx = tsh.ShardingCtx(FakeMesh(("data", "model"), (16, 16)),
                          tsh.TRAIN_RULES)
    # divisible: heads stay on model
    assert ctx.pspec(("embed", "heads", "head_dim"), (5120, 32, 128)) == \
        ("data", "model", None)
    # 40 heads not divisible by 16 -> TP moves to head_dim
    assert ctx.pspec(("embed", "heads", "head_dim"), (5120, 40, 128)) == \
        ("data", None, "model")
    # batch=1 decode cache -> data axis lands on kv_seq
    spec = ctx.pspec(("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                     (9, 1, 524288, 32, 80))
    assert spec[2] == "data" and spec[1] is None


def test_shard_grid_math():
    entries = tsh.normalize_spec((("data",), ("model",)), 3)
    assert entries == (("data",), ("model",), ())
    grid = tsh.shard_grid(entries, {"data": 4, "model": 2}, (64, 6, 5))
    assert grid == (4, 2, 1)
    # indivisible dim stays unsharded rather than going ragged
    assert tsh.shard_grid(entries, {"data": 4, "model": 2},
                          (63, 6, 5)) == (1, 2, 1)
    slices = list(tsh.shard_slices((2, 2), (4, 6)))
    assert slices[0] == (0, (slice(0, 2), slice(0, 3)))
    assert slices[-1] == (3, (slice(2, 4), slice(3, 6)))
    blocks = np.zeros((4, 6))
    for _, sl in slices:
        blocks[sl] += 1
    np.testing.assert_array_equal(blocks, np.ones((4, 6)))  # exact tiling
    mesh = FakeMesh(("data", "model"), (4, 2))
    assert tsh.mesh_desc(mesh) == jsh.mesh_desc(mesh) == \
        {"axes": ["data", "model"], "shape": [4, 2]}


def test_vmapped_axes_reserve_their_mesh_axes():
    """Under ``vmap_logical("slots")`` (SERVE_RULES: slots on data) an
    interior tensor cannot take 'data' — the reference's reservation —
    and outside any vmap it can."""
    mesh = FakeMesh(("data", "model"), (4, 2))
    for mod in (jsh, tsh):
        ctx = mod.ShardingCtx(mesh, mod.SERVE_RULES)
        with mod.use_sharding(mesh, mod.SERVE_RULES):
            free = ctx.pspec(("batch", "heads"), (8, 4),
                             reserved=mod._reserved_axes(ctx))
            with mod.vmapped_axes("slots"):
                held = ctx.pspec(("batch", "heads"), (8, 4),
                                 reserved=mod._reserved_axes(ctx))
        assert tuple(free) == ("data", "model")
        assert tuple(held) == (None, "model")
    seen = []
    out = tsh.vmap_logical(lambda x: seen.append(tsh._vmap_prefix()[:]) or x,
                           "cores")(3)
    assert out == 3 and seen == [["cores"]] and tsh._vmap_prefix() == []


def test_shard_act_is_a_no_op_outside_a_context():
    x = torch.randn(2, 3, 4)
    assert tsh.current_ctx() is None
    assert tsh.shard_act(x, ("batch", "seq", "embed_act")) is x
    with tsh.use_sharding(FakeMesh(("data",), (2,)), tsh.TRAIN_RULES):
        # a plain tensor passes through inside a context too
        assert tsh.shard_act(x, ("batch", "seq", "embed_act")) is x
    assert tsh.current_ctx() is None


def test_tree_shardings_lay_out_every_leaf():
    """``tree_shardings`` gives each leaf of an axes tree the placements of
    its spec (at its shape, through the divisibility fallback)."""
    cfg = get_config("internlm2-1.8b")
    specs = api.model_specs(cfg)
    axes = tpspec.logical_axes(specs)
    structs = {}

    def walk(sp, out):
        for k, v in sp.items():
            if isinstance(v, dict):
                out[k] = {}
                walk(v, out[k])
            else:
                out[k] = types.SimpleNamespace(shape=v.shape)
    walk(specs, structs)
    mesh = FakeMesh(("data", "model"), (16, 16))
    lay = tsh.tree_shardings(axes, mesh, tsh.TRAIN_RULES, structs)
    ctx = tsh.ShardingCtx(mesh, tsh.TRAIN_RULES)
    for path, ax in _axes_leaves(axes):
        got, st = lay, structs
        for k in path:
            got, st = got[k], st[k]
        assert got == tsh.spec_placements(ctx.pspec(ax, st.shape),
                                          ("data", "model")), path


def test_zeros_tree_outside_a_context_is_the_plain_cache():
    """Outside a mesh context ``zeros_tree`` (``init_cache``, the
    prefill's empty cache) gives plain zeros of the specs on the device,
    ``len`` on the host."""
    from repro_torch.models import dense

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    specs = dense.cache_specs(cfg, 2, 8)
    got = dense.init_cache(cfg, 2, 8, device="cpu")
    assert sorted(got) == sorted(specs)
    for k, (shape, dt) in specs.items():
        assert not tsh.is_dtensor(got[k]) and got[k].device.type == "cpu"
        assert got[k].dtype == dt and tuple(got[k].shape) == tuple(shape)
        assert not got[k].any()


def test_split_last_on_a_plain_tensor_is_reshape():
    x = torch.arange(2 * 3 * 8.0).reshape(2, 3, 8)
    assert torch.equal(tsh.split_last(x, (2, -1, 4, 2)),
                       x.reshape(2, 3, 4, 2))
