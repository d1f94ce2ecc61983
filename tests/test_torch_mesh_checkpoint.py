"""Sharded checkpoints of the port (``save(..., ctx=, axes=)``) against the
JAX package's, on fake meshes (no devices): the files and the MANIFEST of
a save under a ``ShardingCtx`` of a (4, 2) mesh and ``TRAIN_RULES`` are
byte for byte the reference's for the same state; the 8 -> 4 elastic round
trip of ``tests/test_checkpoint_faults.py`` passes in the port; and each
package restores the other's (4, 2) save under a (2, 2) ctx bitwise. The
save from ranks holding DTensors on a real mesh is in
``test_torch_mesh_steps.py``.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist.checkpoint import CheckpointManager as JCkpt
from repro.dist.sharding import TRAIN_RULES as J_RULES
from repro.dist.sharding import ShardingCtx as JCtx
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.dist.fault_tolerance import (plan_elastic_mesh,
                                              survivor_split)
from repro_torch.dist.sharding import TRAIN_RULES, ShardingCtx, mesh_desc
from repro_torch.launch import train as tlaunch
from repro_torch.models import api
from repro_torch.optim import optimizer as topt
from repro_torch.utils.convert import load_jax_params
from repro_torch.utils.tree import tree_leaves, tree_map

ARCH = "qwen1.5-0.5b"
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


class FakeMesh:
    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


MESH8 = FakeMesh(("data", "model"), (4, 2))
MESH4 = FakeMesh(("data", "model"), (2, 2))
AXES = {"params": {"emb": ("embed", "heads"), "w": ("embed", "ffn")},
        "step": ()}


def _state(step: int):
    """A tree whose values identify the step they were saved at (the
    reference suite's, as tensors)."""
    return {"params": {
        "emb": torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
        + step,
        "w": torch.full((8, 16), float(step), dtype=torch.bfloat16)},
        "step": torch.tensor(step, dtype=torch.int32)}


def _assert_is_step(restored, step: int):
    torch.testing.assert_close(restored["params"]["emb"],
                               _state(step)["params"]["emb"], rtol=0, atol=0)
    assert torch.equal(restored["params"]["w"].float(),
                       torch.full((8, 16), float(step)))
    assert int(restored["step"]) == step


@functools.lru_cache(maxsize=None)
def _lm_states():
    """The reduced LM's {"params", "opt"} state in both packages (the
    JAX package's initial parameters) and its logical axes."""
    jcfg, tcfg = j_get_config(ARCH, reduced=True), get_config(ARCH,
                                                              reduced=True)
    jp = japi.init_model(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tp = tree_map(lambda p: p.detach().clone(), load_jax_params(
        api.init_model(tcfg, 0, device="cpu"), np_params))
    jstate = {"params": jp, "opt": jopt.init_state(
        jp, jopt.AdamWConfig(**OPT))}
    tstate = {"params": tp, "opt": topt.init_state(
        tp, topt.AdamWConfig(**OPT))}
    axes = tlaunch._build_state_axes(tcfg, topt.AdamWConfig(**OPT))
    assert axes == jlaunch._build_state_axes(jcfg, jopt.AdamWConfig(**OPT))
    return jstate, tstate, axes


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mesh", [MESH8, MESH4], ids=["4x2", "2x2"])
def test_sharded_save_matches_jax(tmp_path, mesh):
    jstate, tstate, axes = _lm_states()
    JCkpt(str(tmp_path / "jax")).save(jstate, 3, ctx=JCtx(mesh, J_RULES),
                                      axes=axes)
    CheckpointManager(str(tmp_path / "port")).save(
        tstate, 3, ctx=ShardingCtx(mesh, TRAIN_RULES), axes=axes)
    ref = _files(tmp_path / "jax" / "step_00000003")
    out = _files(tmp_path / "port" / "step_00000003")
    assert sorted(out) == sorted(ref)
    assert json.loads(out.pop("MANIFEST")) == json.loads(ref.pop("MANIFEST"))
    assert out == ref
    assert len(out) > len(tree_leaves(tstate))  # leaves were cut


def test_elastic_roundtrip_8dev_to_4dev(tmp_path):
    """Saved sharded under an 8-device mesh, restored bit-exactly onto the
    4-device mesh ``plan_elastic_mesh`` produces after a host dies, and
    back up."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    ctx8 = ShardingCtx(MESH8, TRAIN_RULES)
    mgr.save(_state(9), 9, ctx=ctx8, axes=AXES)
    assert mgr.saved_mesh() == mesh_desc(MESH8)

    plan = plan_elastic_mesh(total_hosts=2, dead_hosts=1, chips_per_host=4,
                             model_parallel=2, max_data=4)
    assert plan.num_devices == 4
    mesh4 = FakeMesh(("data", "model"),
                     (plan.data_parallel, plan.model_parallel))
    ctx4 = ShardingCtx(mesh4, TRAIN_RULES)
    restored, step = mgr.restore_latest(_state(0), ctx=ctx4, axes=AXES)
    assert step == 9
    _assert_is_step(restored, 9)
    assert survivor_split(2, {1}) == {0: 0}

    mgr.save(restored, 10, ctx=ctx4, axes=AXES)
    assert mgr.saved_mesh() == mesh_desc(mesh4)
    again, step = mgr.restore_latest(_state(0), ctx=ctx8, axes=AXES)
    assert step == 10
    _assert_is_step(again, 9)  # values still from step 9's state
    manifest = json.load(open(tmp_path / "step_00000010" / "MANIFEST"))
    assert manifest["leaves"][0]["grid"] == [2, 2]  # (2, 2), not (4, 2)


def test_cross_load_between_meshes_both_ways(tmp_path):
    """The reference's save under (4, 2) restores in the port under a
    (2, 2) ctx bitwise, and the port's save under (4, 2) in the
    reference."""
    jstate, tstate, axes = _lm_states()
    JCkpt(str(tmp_path / "jax")).save(jstate, 4, ctx=JCtx(MESH8, J_RULES),
                                      axes=axes)
    CheckpointManager(str(tmp_path / "port")).save(
        tstate, 4, ctx=ShardingCtx(MESH8, TRAIN_RULES), axes=axes)
    restored, step = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        tstate, ctx=ShardingCtx(MESH4, TRAIN_RULES), axes=axes)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(jstate), tree_leaves(restored),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back, step = JCkpt(str(tmp_path / "port")).restore_latest(
        jstate, ctx=JCtx(MESH4, J_RULES), axes=axes)
    assert step == 4
    for a, b in zip(tree_leaves(tstate), jax.tree_util.tree_leaves(back),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_axes_tree_must_match_the_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="axes tree"):
        mgr.save(_state(1), 1, ctx=ShardingCtx(MESH8, TRAIN_RULES),
                 axes={"params": {"emb": ("embed", "heads")}, "step": ()})
    mgr.save(_state(1), 1, ctx=ShardingCtx(MESH8, TRAIN_RULES), axes=AXES)
    with pytest.raises(ValueError, match="axes tree"):
        mgr.restore_latest(_state(0), ctx=ShardingCtx(MESH4, TRAIN_RULES),
                           axes={"step": ()})
