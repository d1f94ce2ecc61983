"""The port's checkpoint manager (``repro_torch.dist.checkpoint``) against
the JAX package's (``repro.dist.checkpoint``): the v2 format is shared, so
a checkpoint either package writes restores in the other, bitwise (a bf16
leaf included: widened to f32 on disk, cast back on restore), and a JAX
checkpoint cut into a shard grid under a mesh restores here reassembled.
The one-host fault cases of ``tests/test_checkpoint_faults.py`` run against
the port as cases of one parametrised test: each must fall back to the
previous complete step, never raise, never hand back corrupted values.
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.checkpoint import CheckpointManager as JManager
from repro.dist.sharding import TRAIN_RULES, ShardingCtx
from repro_torch.dist.checkpoint import (MANIFEST, CheckpointManager,
                                         TemplateMismatch, _shard_name)
from repro_torch.utils.tree import tree_flatten


class FakeMesh:
    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


def _tstate(step: int):
    """The port's tree whose values identify the step they were saved at."""
    return {
        "params": {
            "emb": torch.arange(64 * 6, dtype=torch.float32).reshape(64, 6)
            + step,
            "w": torch.full((8, 16), float(step), dtype=torch.bfloat16),
        },
        "step": torch.tensor(step, dtype=torch.int32),
    }


def _jstate(step: int):
    return {
        "params": {
            "emb": jnp.arange(64 * 6, dtype=jnp.float32).reshape(64, 6) + step,
            "w": jnp.full((8, 16), float(step), jnp.bfloat16),
        },
        "step": jnp.asarray(step),
    }


def _assert_is_step(restored, step: int):
    np.testing.assert_array_equal(restored["params"]["emb"].numpy(),
                                  _tstate(step)["params"]["emb"].numpy())
    assert restored["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(restored["params"]["w"].float().numpy(),
                                  np.full((8, 16), float(step), np.float32))
    assert restored["step"].dtype == torch.int32
    assert restored["step"].shape == ()
    assert restored["params"]["emb"].shape == (64, 6)
    assert int(restored["step"]) == step


def test_leaf_order_is_jax_tree_flatten_order():
    t_leaves, _ = tree_flatten(_tstate(3))
    j_leaves = jax.tree_util.tree_leaves(_jstate(3))
    assert [tuple(x.shape) for x in t_leaves] == \
        [tuple(x.shape) for x in j_leaves]


@pytest.mark.parametrize("sharded", [False, True], ids=["one-shard", "mesh8"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, sharded):
    jm = JManager(str(tmp_path), keep=3)
    kw = {}
    if sharded:
        kw = dict(ctx=ShardingCtx(FakeMesh(("data", "model"), (4, 2)),
                                  TRAIN_RULES),
                  axes={"params": {"emb": ("embed", "heads"),
                                   "w": ("embed", "ffn")}, "step": ()})
    jm.save(_jstate(7), 7, **kw)
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(
        _tstate(0))
    assert step == 7
    _assert_is_step(restored, 7)


def test_port_checkpoint_restores_in_jax(tmp_path):
    CheckpointManager(str(tmp_path)).save(_tstate(5), 5)
    restored, step = JManager(str(tmp_path)).restore_latest(_jstate(0))
    assert step == 5
    np.testing.assert_array_equal(np.asarray(restored["params"]["emb"]),
                                  np.asarray(_jstate(5)["params"]["emb"]))
    assert restored["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"], np.float32),
        np.full((8, 16), 5.0, np.float32))
    assert int(restored["step"]) == 5
    with open(os.path.join(str(tmp_path), "step_00000005", MANIFEST)) as f:
        man = json.load(f)
    assert [e["dtype"] for e in man["leaves"]] == \
        ["float32", "bfloat16", "int32"]


def test_manifests_of_both_packages_agree(tmp_path):
    """One unsharded state written by each package: the same MANIFEST
    fields and the same shard bytes."""
    a, b = tmp_path / "jax", tmp_path / "port"
    JManager(str(a)).save(_jstate(2), 2)
    CheckpointManager(str(b)).save(_tstate(2), 2)
    ma = json.load(open(a / "step_00000002" / MANIFEST))
    mb = json.load(open(b / "step_00000002" / MANIFEST))
    assert ma == mb


def test_v1_format_restores(tmp_path):
    leaves, _ = tree_flatten(_tstate(4))
    d = os.path.join(str(tmp_path), "step_00000004")
    os.makedirs(d)
    man = {"step": 4, "num_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.numpy()
        name = f"leaf_{i:05d}.npy"
        np.save(os.path.join(d, name), arr)
        sha = hashlib.sha256(open(os.path.join(d, name), "rb").read())
        man["leaves"].append({"file": name, "dtype": str(arr.dtype),
                              "shape": list(arr.shape),
                              "sha256": sha.hexdigest()})
    with open(os.path.join(d, MANIFEST), "w") as f:
        json.dump(man, f)
    restored, step = CheckpointManager(str(tmp_path)).restore_latest(
        _tstate(0))
    assert step == 4
    _assert_is_step(restored, 4)


@pytest.fixture
def mgr(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=5)
    m.save(_tstate(1), 1)
    m.save(_tstate(2), 2)
    return m


def _newest(mgr):
    return os.path.join(mgr.dir, "step_00000002")


def _torn(mgr):
    path = os.path.join(_newest(mgr), _shard_name(0, 0))
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _bad_sha(mgr):
    path = os.path.join(_newest(mgr), _shard_name(0, 0))
    np.save(path, np.load(path) + 1000.0)  # well-formed npy, wrong contents


def _missing(mgr):
    os.remove(os.path.join(_newest(mgr), _shard_name(1, 0)))


def _manifest(mgr):
    with open(os.path.join(_newest(mgr), MANIFEST), "w") as f:
        f.write('{"format": 2, "step": 2, "num_leav')  # torn json


def _interrupted(mgr):
    d = os.path.join(mgr.dir, "step_00000003")
    os.makedirs(d)
    np.save(os.path.join(d, _shard_name(0, 0)), np.zeros(4))


def _stage(mgr):
    assert mgr.save(_tstate(3), 3, process_index=1, process_count=2) is None


FAULTS = {"torn-shard": (_torn, 1), "bad-sha256": (_bad_sha, 1),
          "missing-shard": (_missing, 1), "corrupt-manifest": (_manifest, 1),
          "interrupted-write": (_interrupted, 2),
          "multiwriter-stage": (_stage, 2)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_falls_back(mgr, fault):
    inject, want = FAULTS[fault]
    inject(mgr)
    restored, step = mgr.restore_latest(_tstate(0))
    assert step == want
    _assert_is_step(restored, want)
    debris = [n for n in os.listdir(mgr.dir)
              if n.startswith(".stage_") or n == "step_00000003"]
    CheckpointManager(mgr.dir, keep=5)  # the init sweep removes debris
    assert not any(os.path.isdir(os.path.join(mgr.dir, n)) for n in debris)


def test_multiwriter_finalize_without_peers_fails_fast(mgr):
    with pytest.raises(RuntimeError, match="barrier"):
        mgr.save(_tstate(3), 3, process_index=0, process_count=2)
    restored, step = mgr.restore_latest(_tstate(0))
    assert step == 2
    _assert_is_step(restored, 2)


def test_multiwriter_completes_after_finalizer(mgr):
    assert mgr.save(_tstate(3), 3, process_index=1, process_count=2) is None
    assert mgr.save(_tstate(3), 3, process_index=0,
                    process_count=2) is not None
    restored, step = mgr.restore_latest(_tstate(0))
    assert step == 3
    _assert_is_step(restored, 3)


def test_template_mismatch_and_all_corrupt(mgr, tmp_path):
    with pytest.raises(TemplateMismatch):
        mgr.restore_latest({"params": {"emb": torch.zeros(64, 6)}})
    other = CheckpointManager(str(tmp_path / "x"), keep=5)
    other.save(_tstate(1), 1)
    np.save(os.path.join(other.dir, "step_00000001", _shard_name(0, 0)),
            np.zeros((64, 6), np.float32))
    assert other.restore_latest(_tstate(0)) is None


def test_keep_collects_old_steps_and_ctx_raises(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        m.save(_tstate(s), s)
    assert m._complete_steps() == [2, 3]
    # ctx/axes: step 4 is cut into the reference's shard grid and the
    # saved mesh recorded; it restores under another mesh's ctx bitwise
    from repro_torch.dist.sharding import TRAIN_RULES as T_RULES
    from repro_torch.dist.sharding import ShardingCtx as TCtx

    axes = {"params": {"emb": ("embed", "heads"), "w": ("embed", "ffn")},
            "step": ()}
    m.save(_tstate(4), 4, ctx=TCtx(FakeMesh(("data", "model"), (4, 2)), T_RULES), axes=axes)
    assert m._complete_steps() == [3, 4]
    assert m.saved_mesh() == {"axes": ["data", "model"], "shape": [4, 2]}
    manifest = json.load(open(os.path.join(m.dir, "step_00000004",
                                           MANIFEST)))
    assert [e["grid"] for e in manifest["leaves"]] == [[4, 2], [4, 2], []]
    assert manifest["leaves"][0]["spec"] == [["data"], ["model"]]
    restored, step = m.restore_latest(
        _tstate(0), ctx=TCtx(FakeMesh(("data", "model"), (2, 2)), T_RULES), axes=axes)
    assert step == 4
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(_tstate(4))[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
