"""The port's training loop (``repro_torch.train.train_loop``) and launcher
(``repro_torch.launch.train``) against the JAX package's on the CPU:
reduced ``qwen1.5-0.5b`` (f32), weights from the JAX package's
``init_model`` (norm weights drawn off 1), the data pipeline's batches
(B 4 × S 16), AdamW with ``eps`` 1e-4 (see ``tests/test_torch_train_step.py``
for why).

- ``train_loop``, 6 steps, ``ckpt_every`` 3, ``log_every`` 2: the logged
  steps equal and their losses within 1e-5 relative of the reference's;
  the ``train/step``, ``ckpt/save`` and ``ckpt/restore`` spans and the
  ``train.*`` counters equal in number;
- 3 steps, then a resumed run to 6, is bitwise the uninterrupted 6; a
  rerun logs "resumed from step 6" and takes no step;
- a trainer checkpoint restores in the reference's ``CheckpointManager``
  and the reference trainer's in the port's, bitwise;
- ``elastic_train`` over 2 hosts with host 1 declared dead at step 4 and a
  checkpoint every 2 steps: the merged history's steps equal the
  reference's, losses within 1e-5 relative;
- ``main([... "--device", "cpu"])`` runs the reference's single-device
  flags; ``--mesh 2x2`` and ``--chips-per-host 4`` raise (ROADMAP item
  14);
- ``examples/torch_lm_generate.py --device cpu --train-steps 5`` trains,
  then generates, for a dense, the hybrid and the enc-dec config.
"""
import functools
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import DataPipeline as JPipe
from repro.dist.checkpoint import CheckpointManager as JCkpt
from repro.launch import train as jlaunch
from repro.models import api as japi
from repro.obs import MetricsRegistry as JMetrics
from repro.obs import Tracer as JTracer
from repro.optim import optimizer as jopt
from repro.train import TrainLoopConfig as JLoop
from repro.train import train_loop as j_train_loop
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataPipeline
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.launch import train as tlaunch
from repro_torch.models import api
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.optim import optimizer as topt
from repro_torch.train import TrainLoopConfig, train_loop
from repro_torch.utils.convert import load_jax_params
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"
B, S = 4, 16
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=6, eps=1e-4)
SPANS = ("train/step", "ckpt/save", "ckpt/restore", "worker/lost")
COUNTERS = ("train.steps", "train.ckpt.saves", "train.ckpt.restores")


@functools.lru_cache(maxsize=None)
def _np_params():
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_model(j_get_config(ARCH, reduced=True),
                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    for sub, name in ((np_params["blocks"], "ln1"),
                      (np_params["blocks"], "ln2"),
                      (np_params, "final_norm")):
        w = sub[name]
        sub[name] = (1.0 + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)
    return np_params


def _tparams():
    return tree_map(lambda p: p.detach().clone(),
                    load_jax_params(api.init_model(
                        get_config(ARCH, reduced=True), 0, device="cpu"),
                        _np_params()))


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _np_params())


def _port_run(ckpt_dir, total, ckpt_every=3, log_every=2):
    tr, reg, log = Tracer(), MetricsRegistry(), []
    cfg = get_config(ARCH, reduced=True)
    p, o, hist = train_loop(
        cfg, _tparams(), DataPipeline(cfg, seq_len=S, global_batch=B),
        topt.AdamWConfig(**OPT),
        TrainLoopConfig(total_steps=total, log_every=log_every,
                        ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
        log_fn=log.append, tracer=tr, metrics_registry=reg)
    return p, o, hist, tr, reg, log


def _jax_run(ckpt_dir, total, ckpt_every=3, log_every=2):
    tr, reg = JTracer(), JMetrics()
    cfg = j_get_config(ARCH, reduced=True)
    p, o, hist = j_train_loop(
        cfg, _jparams(), JPipe(cfg, seq_len=S, global_batch=B),
        jopt.AdamWConfig(**OPT),
        JLoop(total_steps=total, log_every=log_every, ckpt_every=ckpt_every,
              ckpt_dir=ckpt_dir),
        log_fn=lambda s: None, tracer=tr, metrics_registry=reg)
    return p, o, hist, tr, reg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trainer")
    return {"port": _port_run(str(d / "port"), 6),
            "jax": _jax_run(str(d / "jax"), 6), "dir": d}


def _losses_match(hist, ref):
    assert [h["step"] for h in hist] == [h["step"] for h in ref]
    for h, r in zip(hist, ref):
        assert abs(h["loss"] - r["loss"]) <= 1e-5 * abs(r["loss"]), (h, r)


def test_history_matches_jax(runs):
    hist, ref = runs["port"][2], runs["jax"][2]
    assert [h["step"] for h in hist] == [0, 2, 4, 5]
    _losses_match(hist, ref)
    assert all(np.isfinite(h["loss"]) and h["time_s"] > 0 for h in hist)


def test_spans_and_counters_match_jax(runs):
    tr, reg = runs["port"][3], runs["port"][4]
    jtr, jreg = runs["jax"][3], runs["jax"][4]
    for name in SPANS:
        assert tr.count(name) == jtr.count(name), name
    # saves at steps 3 and 6, and the final save at 6
    assert tr.count("train/step") == 6 and tr.count("ckpt/save") == 3
    for name in COUNTERS:
        assert reg[name].value == jreg[name].value, name
    assert reg["train.step_time_s"].count == jreg["train.step_time_s"].count
    assert reg["train.loss"].value == runs["port"][2][-1]["loss"]


def test_resume_is_bitwise_and_rerun_takes_no_step(runs, tmp_path):
    d = str(tmp_path / "resume")
    _port_run(d, 3)
    p, o, hist, tr, reg, log = _port_run(d, 6)
    assert "[trainer] resumed from step 3" in log
    assert [h["step"] for h in hist] == [4, 5]
    ref_p, ref_o = runs["port"][0], runs["port"][1]
    for a, b in zip(tree_leaves(ref_p), tree_leaves(p)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ref_o), tree_leaves(o)):
        assert torch.equal(a, b)
    *_, hist2, tr2, reg2, log2 = _port_run(d, 6)
    assert "[trainer] resumed from step 6" in log2
    assert hist2 == [] and reg2["train.steps"].value == 0
    assert tr2.count("ckpt/save") == 0 and tr2.count("ckpt/restore") == 1


def test_checkpoints_cross_load(runs):
    d = runs["dir"]
    port_p, port_o = runs["port"][0], runs["port"][1]
    jax_p, jax_o = runs["jax"][0], runs["jax"][1]
    # the port's trainer checkpoint in the reference's manager
    restored, step = JCkpt(str(d / "port")).restore_latest(
        {"params": jax_p, "opt": jax_o})
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    tree_leaves({"params": port_p, "opt": port_o})):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the reference trainer's checkpoint in the port's manager
    restored, step = CheckpointManager(str(d / "jax")).restore_latest(
        {"params": port_p, "opt": port_o})
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves({"params": jax_p,
                                               "opt": jax_o}),
                    tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _elastic(launch, cfg, params, pipe, opt_cfg, loop_cfg, step_factory):
    injector = {"armed": True}

    def monitor_factory(n):
        dead_at = 4 if injector.pop("armed", None) else None
        return launch.FailureInjector(num_workers=n, dead_at=dead_at,
                                      dead_worker=1)

    log = []
    _, _, hist = launch.elastic_train(
        cfg, params, pipe, opt_cfg, loop_cfg, step_factory=step_factory,
        total_hosts=2, monitor_factory=monitor_factory, log_fn=log.append)
    return hist, log


def test_elastic_history_matches_jax(tmp_path):
    jcfg, tcfg = j_get_config(ARCH, reduced=True), get_config(ARCH,
                                                              reduced=True)
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)

    def jfactory(dp):
        return jax.jit(j_make_train_step(jcfg, jo, remat=True),
                       donate_argnums=(0, 1))

    ref, jlog = _elastic(
        jlaunch, jcfg, _jparams(),
        JPipe(jcfg, seq_len=S, global_batch=B, host_count=2), jo,
        JLoop(total_steps=6, log_every=1, ckpt_every=2,
              ckpt_dir=str(tmp_path / "jax")), jfactory)
    hist, log = _elastic(
        tlaunch, tcfg, _tparams(),
        DataPipeline(tcfg, seq_len=S, global_batch=B, host_count=2), to,
        TrainLoopConfig(total_steps=6, log_every=1, ckpt_every=2,
                        ckpt_dir=str(tmp_path / "port")),
        tlaunch.make_step_factory(tcfg, to))
    assert [h["step"] for h in ref] == list(range(6))
    _losses_match(hist, ref)
    assert any("hosts [1] lost (1/2 alive)" in s for s in log)
    assert "[trainer] resumed from step 4" in log
    assert [s for s in log if s.startswith("[launch]")] == \
        [s for s in jlog if s.startswith("[launch]")]


def test_main_runs_the_single_device_flags(tmp_path):
    log = []
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "16", "--lr", "1e-3",
            "--microbatches", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "3", "--compress-grads", "--hosts", "2",
            "--simulate-dead-at", "4", "--simulate-dead-worker", "1"]
    hist = tlaunch.main(args, log_fn=log.append)
    assert [h["step"] for h in hist] == [0, 5]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert "[trainer] resumed from step 3" in log
    again = []
    assert tlaunch.main(args, log_fn=again.append) == []
    assert "[trainer] resumed from step 6" in again


def test_mesh_raises():
    """``--mesh 2x2 --device cpu`` runs: the launcher spawns four gloo
    ranks, the step runs on DTensors, and the checkpoints are cut into
    the (2, 2) grid (the elastic re-mesh is ``test_torch_mesh_launch.py``)."""
    import json
    import tempfile

    d = tempfile.mkdtemp()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--mesh", "2x2", "--steps", "2",
         "--batch", "4", "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[trainer] step=1" in proc.stdout and \
        "[train] final loss" in proc.stdout
    with open(os.path.join(d, "step_00000002", "MANIFEST")) as f:
        manifest = json.load(f)
    assert manifest["mesh"] == {"axes": ["data", "model"], "shape": [2, 2]}
    assert [2, 2] in [e["grid"][-2:] for e in manifest["leaves"]]


def test_chips_per_host_raises():
    """More than one chip a host only sizes a mesh's elastic plan: without
    ``--mesh`` the flag and ``elastic_train``'s argument raise instead of
    being ignored."""
    with pytest.raises(ValueError, match="without a mesh"):
        tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--chips-per-host", "4"])
    cfg = get_config(ARCH, reduced=True)
    with pytest.raises(ValueError, match="without a mesh"):
        tlaunch.elastic_train(cfg, _tparams(), None, None, None,
                              step_factory=None, chips_per_host=4)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_example_trains_then_generates(arch, capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_lm_generate", ROOT / "examples" / "torch_lm_generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--arch", arch, "--device", "cpu", "--train-steps", "5",
                    "--gen-steps", "4"])
    assert tuple(out.shape) == (2, 8 + 4)
    text = capsys.readouterr().out
    assert "[trainer] step=0" in text and "[trainer] step=4" in text


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", ARCH, "--reduced", "--steps", "1"])
