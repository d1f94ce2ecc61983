"""The elastic launcher on a mesh: the port's ``elastic_train`` on two gloo
ranks against the JAX package's on two fake CPU devices, and the port's
CLI with ``--mesh``.

Parity is held as ``test_torch_trainer.py::test_elastic_history_matches_jax``
holds it on one device: the same JAX-initialised parameters go into both
``elastic_train`` calls with ``mesh_shape=(2, 1)``, ``total_hosts=2`` and a
``FailureInjector`` death at step 4; both re-plan to (1, 1), restore the
sharded checkpoint of step 4 and finish. The merged histories agree within
the loss limit (1e-5 relative), the ``[launch]`` lines are equal, and the
rank outside the new mesh leaves the loop with the history it had.

``python -m repro_torch.launch.train ... --mesh 2x1 --hosts 2
--simulate-dead-at 4`` spawns its ranks, re-plans, resumes from step 3 and
finishes, as the reference's launcher does with the same flags.

The three subprocesses (port ranks, JAX side, CLI) run at the same time
from one module fixture.
"""
import os
import pickle

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from test_torch_mesh_ranks import (ARCHS, read_log, start_cli, start_jax,
                                   start_job, wait_all)

ARCH = ARCHS[0]
B, S = 4, 16
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=6, eps=1e-4)
CLI = ["-m", "repro_torch.launch.train", "--arch", ARCH, "--reduced",
       "--device", "cpu", "--batch", "4", "--seq", "32", "--mesh", "2x1",
       "--hosts", "2", "--steps", "6", "--ckpt-every", "3",
       "--simulate-dead-at", "4"]


def _np_params():
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_model(j_get_config(ARCH, reduced=True),
                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    blocks = np_params["blocks"]
    for sub, name in ((blocks, "ln1"), (blocks, "ln2"),
                      (np_params, "final_norm")):
        w = sub[name]
        sub[name] = (1.0 + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)
    return np_params


def _jax_side(io_dir):
    """The reference's elastic_train on 2 fake devices (a subprocess)."""
    import jax.numpy as jnp

    from repro.data import DataPipeline
    from repro.launch import train as jlaunch
    from repro.optim import AdamWConfig
    from repro.train import TrainLoopConfig
    from repro.train.train_step import make_train_step

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = j_get_config(ARCH, reduced=True)
    opt = AdamWConfig(**inp["opt"])
    injector = {"armed": True}

    def monitor_factory(n):
        dead_at = 4 if injector.pop("armed", None) else None
        return jlaunch.FailureInjector(num_workers=n, dead_at=dead_at,
                                       dead_worker=1)

    def step_factory(dp):
        return jax.jit(make_train_step(cfg, opt, remat=True),
                       donate_argnums=(0, 1))

    log = []
    _, _, hist = jlaunch.elastic_train(
        cfg, jax.tree_util.tree_map(jnp.asarray, inp["params"]),
        DataPipeline(cfg, seq_len=inp["seq"], global_batch=inp["batch"],
                     host_count=2), opt,
        TrainLoopConfig(total_steps=6, log_every=1, ckpt_every=2,
                        ckpt_dir=os.path.join(io_dir, "ck_jax")),
        step_factory=step_factory, mesh_shape=(2, 1), total_hosts=2,
        monitor_factory=monitor_factory, log_fn=log.append)
    with open(os.path.join(io_dir, "jax.pkl"), "wb") as f:
        pickle.dump({"hist": hist, "log": log}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("mesh_launch"))
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump({"params": _np_params(), "opt": OPT, "batch": B,
                     "seq": S}, f)
    wait_all(io_dir, [
        start_job("elastic", io_dir),
        start_jax("from test_torch_mesh_launch import _jax_side; "
                  f"_jax_side({io_dir!r})", io_dir, devices=2),
        start_cli(CLI + ["--ckpt-dir", os.path.join(io_dir, "ck_cli")],
                  io_dir)])
    ranks = [pickle.load(open(os.path.join(io_dir, f"elastic.rank{r}.pkl"),
                              "rb")) for r in (0, 1)]
    with open(os.path.join(io_dir, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    return {"ranks": ranks, "jax": ref, "cli": read_log(io_dir, "cli"),
            "dir": io_dir}


def test_elastic_history_matches_jax(runs):
    port, ref = runs["ranks"][0], runs["jax"]
    assert [h["step"] for h in ref["hist"]] == list(range(6))
    assert [h["step"] for h in port["hist"]] == list(range(6))
    for a, b in zip(port["hist"], ref["hist"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
    assert [s for s in port["log"] if s.startswith("[launch]")] == \
        [s for s in ref["log"] if s.startswith("[launch]")]
    assert "[launch] elastic plan after losing [1]: mesh=(1,1) idle=0" in \
        port["log"]
    assert "[trainer] resumed from step 4" in port["log"]


def test_rank_outside_the_new_mesh_leaves(runs):
    out = runs["ranks"][1]
    assert out["left"] and not runs["ranks"][0]["left"]
    # it trained in lockstep until the death, then left with that history
    assert [h["step"] for h in out["hist"]] == list(range(4))
    for a, b in zip(out["hist"], runs["ranks"][0]["hist"]):
        assert a["loss"] == b["loss"]


def test_sharded_checkpoints_after_the_replan(runs):
    """Steps 2 and 4 were saved by both ranks under (2, 1); 6 by the one
    survivor under (1, 1)."""
    import json

    d = os.path.join(runs["dir"], "ck")
    meshes = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name, "MANIFEST")) as f:
            meshes[name] = json.load(f)["mesh"]["shape"]
    assert meshes == {"step_00000002": [2, 1], "step_00000004": [2, 1],
                      "step_00000006": [1, 1]}


def test_cli_spawns_replans_and_resumes(runs):
    out = runs["cli"]
    assert "[launch] elastic plan after losing [1]: mesh=(1,1) idle=0" in out
    assert "[trainer] resumed from step 3" in out
    assert "[train] final loss" in out
    assert out.count("[train] qwen1.5-0.5b-reduced") == 1  # rank 0 prints
