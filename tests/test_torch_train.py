"""The denoiser's training path in the port against the JAX package, on
the CPU: the rectified-flow loss and its gradients, AdamW, the schedules,
and the two examples end to end.

Tolerances: the loss within 1e-6 relative with the JAX package's own
draws of ``t`` and ``eps`` injected (``diffusion_loss_from``: jax.random
cannot be replayed in torch); gradients by ``torch.autograd`` against
``jax.grad`` at the micro DiT in f32 compute within 1e-5 relative per leaf
in the L2 norm (``||g_port - g_jax|| <= 1e-5 * ||g_jax||``: 0.6e-6 to
2.8e-6 here; the largest elementwise gap, ``t_mlp1``'s, is 1.05e-5 of that
leaf's largest element, from backward sums taken in other orders); AdamW over 5 chained steps
within 1e-6 relative in ``w32``, ``m`` and ``v`` with ``step`` equal
(torch's and XLA's ``cos`` and ``pow`` may differ in the last ulp).
"""
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
from repro.diffusion import diffusion_loss as j_loss
from repro.diffusion import init_wrapper as j_init_wrapper
from repro.diffusion.schedules import RectifiedFlow as JRF
from repro.diffusion.schedules import VPCosine as JVP
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.diffusion import (diffusion_loss, diffusion_loss_from,
                                   init_wrapper)
from repro_torch.diffusion.schedules import RectifiedFlow, VPCosine
from repro_torch.optim import optimizer as topt
from repro_torch.utils.convert import load_jax_params
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAT, SEQ, B = 8, 8, 4


def _rel_close(out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert np.max(np.abs(out - ref)) <= rel * max(np.max(np.abs(ref)), 1e-30)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("chords-dit-xl", reduced=True)
    tcfg = get_config("chords-dit-xl", reduced=True)
    params = j_init_wrapper(jcfg, LAT, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(init_wrapper(tcfg, LAT, device="cpu"),
                              jax.tree_util.tree_map(np.array, params))
    x1 = jax.random.normal(jax.random.PRNGKey(4), (B, SEQ, LAT))
    key = jax.random.PRNGKey(5)
    # the draws jax's diffusion_loss makes from `key`
    k1, k2 = jax.random.split(key)
    t = jax.random.uniform(k1, (B, 1, 1), minval=0.0, maxval=1.0)
    eps = jax.random.normal(k2, x1.shape, x1.dtype)
    return jcfg, params, tcfg, tparams, x1, key, np.array(t), np.array(eps)


def _trainable(tparams):
    return tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)


def test_loss_matches_jax(setup):
    jcfg, params, tcfg, tparams, x1, key, t, eps = setup
    lj = float(j_loss(params, jcfg, x1, key))
    with torch.no_grad():
        lt = float(diffusion_loss_from(tparams, tcfg,
                                       torch.from_numpy(np.array(x1)),
                                       torch.from_numpy(t),
                                       torch.from_numpy(eps)))
    assert abs(lt - lj) <= 1e-6 * abs(lj), (lt, lj)


def test_gradients_match_jax(setup):
    jcfg, params, tcfg, tparams, x1, key, t, eps = setup
    gj = jax.grad(lambda p: j_loss(p, jcfg, x1, key))(params)
    p = _trainable(tparams)
    loss = diffusion_loss_from(p, tcfg, torch.from_numpy(np.array(x1)),
                               torch.from_numpy(t), torch.from_numpy(eps))
    leaves = tree_leaves(p)
    gt = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    jl = jax.tree_util.tree_leaves(gj)
    assert len(jl) == len(gt)
    for a, b in zip(jl, gt):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if np.max(np.abs(a)) == 0.0:  # unused: the token embedding
            assert float(b.abs().max()) == 0.0
            continue
        b = b.numpy().astype(np.float64)
        a = a.astype(np.float64)
        assert np.linalg.norm(b - a) <= 1e-5 * np.linalg.norm(a)


def test_loss_with_kernels_under_autograd_raises(setup):
    _, _, tcfg, tparams, x1, _, t, eps = setup
    args = (torch.from_numpy(np.array(x1)), torch.from_numpy(t),
            torch.from_numpy(eps))
    with pytest.raises(ValueError, match="no backward"):
        diffusion_loss_from(_trainable(tparams),
                            tcfg.replace(use_kernels=True), *args)
    with torch.no_grad():  # no autograd: the kernels may run
        diffusion_loss_from(tparams, tcfg.replace(use_kernels=True), *args)


def test_diffusion_loss_draws_from_the_generator(setup):
    _, _, tcfg, tparams, x1, _, _, _ = setup
    x = torch.from_numpy(np.array(x1))
    with torch.no_grad():
        a, b, c = (diffusion_loss(tparams, tcfg, x,
                                  torch.Generator().manual_seed(s))
                   for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_schedules_match_jax():
    rng = np.random.default_rng(0)
    x1, eps, v = (rng.standard_normal((3, 5)).astype(np.float32)
                  for _ in range(3))
    t = np.float32(0.37)
    tx1, teps, tv = (torch.from_numpy(a) for a in (x1, eps, v))
    np.testing.assert_array_equal(RectifiedFlow().x_t(tx1, teps, 0.37),
                                  np.asarray(JRF().x_t(x1, eps, t)))
    np.testing.assert_array_equal(RectifiedFlow().velocity_target(tx1, teps),
                                  np.asarray(JRF().velocity_target(x1, eps)))
    for name in ("alpha", "sigma", "dalpha", "dsigma"):
        np.testing.assert_allclose(float(getattr(VPCosine(), name)(0.37)),
                                   float(getattr(JVP(), name)(t)), rtol=1e-6)
    np.testing.assert_allclose(VPCosine().drift_from_eps(teps, tx1, 0.37),
                               np.asarray(JVP().drift_from_eps(eps, x1, t)),
                               rtol=1e-5, atol=1e-6)


def _tree(rng):
    return {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal((16,)).astype(np.float32),
                  "d": rng.standard_normal((2, 3)).astype(np.float32)}}


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_jax_over_five_steps(compress):
    rng = np.random.default_rng(1)
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
                  grad_clip=1.0, compress_grads=compress)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(torch.from_numpy, p0)
    js, ts = jopt.init_state(jp, jcfg), topt.init_state(tp, tcfg)
    for i in range(5):
        g = _tree(rng)
        if i == 2:  # a step the global-norm clip scales
            g = {k: (v * 10 if not isinstance(v, dict)
                     else {kk: vv * 10 for kk, vv in v.items()})
                 for k, v in g.items()}
        jp, js, jm = jopt.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = topt.apply_updates(tp, tree_map(torch.from_numpy, g),
                                        ts, tcfg)
        _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]), 1e-6)
        _rel_close(float(tm["lr"]), float(jm["lr"]), 1e-6)
    assert int(ts["step"]) == int(js["step"]) == 5
    for name in ("w32", "m", "v") + (("err",) if compress else ()):
        for a, b in zip(jax.tree_util.tree_leaves(js[name]),
                        tree_leaves(ts[name])):
            _rel_close(b.numpy(), a, 1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        _rel_close(b.numpy(), a, 1e-6)


def test_quantize_ef_rounds_half_to_even():
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])
    deq, err = topt._quantize_ef(g, torch.zeros(5))
    jdeq, jerr = jopt._quantize_ef(jnp.asarray(g.numpy()), jnp.zeros(5))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def test_lr_schedule_matches_jax():
    cfg_kw = dict(lr=3e-4, warmup_steps=100, total_steps=1000)
    jc, tc = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    for step in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 5000):
        _rel_close(float(topt.lr_at(tc, torch.tensor(step, dtype=torch.int32))),
                   float(jopt.lr_at(jc, jnp.asarray(step, jnp.int32))), 1e-6)


def test_state_layout_and_unported_paths():
    tp = tree_map(torch.from_numpy, _tree(np.random.default_rng(2)))
    st = topt.init_state(tp, topt.AdamWConfig(compress_grads=True))
    assert sorted(st) == ["err", "m", "step", "v", "w32"]
    assert st["step"].dtype == torch.int32
    w32 = tree_leaves(st["w32"])
    assert all(w.dtype == torch.float32 for w in w32)
    assert all(w.data_ptr() != p.data_ptr()
               for w, p in zip(w32, tree_leaves(tp)))
    assert [tuple(x.shape) for x in tree_flatten(st["m"])[0]] == \
        [(4, 8), (16,), (2, 3)]
    # grad_shards > 1: the residual takes a leading [W] groups dim, as the
    # reference's; its logical axes lead with "groups"
    jp = jax.tree_util.tree_map(jnp.asarray, tree_map(
        lambda t: t.numpy(), tp))
    for w in (1, 2):
        cfg_c = topt.AdamWConfig(compress_grads=True)
        st_w = topt.init_state(tp, cfg_c, grad_shards=w)
        ref_w = jopt.init_state(jp, jopt.AdamWConfig(compress_grads=True),
                                grad_shards=w)
        assert [tuple(x.shape) for x in tree_leaves(st_w["err"])] == \
            [tuple(x.shape) for x in jax.tree_util.tree_leaves(ref_w["err"])]
    ax = {"a": ("embed", "ffn"), "b": (None,), "c": ("heads", None)}
    assert topt.state_axes(ax, cfg_c, grad_shards=2) == \
        jopt.state_axes(ax, jopt.AdamWConfig(compress_grads=True),
                        grad_shards=2)
    assert topt.state_axes(ax, topt.AdamWConfig()) == \
        jopt.state_axes(ax, jopt.AdamWConfig())
    # reduced_err: the wire collective's residual is carried as the new
    # err and the local quantization model is skipped, as the reference's
    cfg_c = topt.AdamWConfig(compress_grads=True)
    grads = tree_map(lambda t: 0.5 * t, tp)
    red = tree_map(lambda t: torch.full_like(t, 0.25), tp)
    st_c = topt.init_state(tp, cfg_c)
    new_p, new_s, _ = topt.apply_updates(tp, grads, st_c, cfg_c,
                                         reduced_err=red)
    ref_p, ref_s, _ = jopt.apply_updates(
        jp, jax.tree_util.tree_map(lambda t: 0.5 * t, jp),
        jopt.init_state(jp, jopt.AdamWConfig(compress_grads=True)),
        jopt.AdamWConfig(compress_grads=True),
        reduced_err=jax.tree_util.tree_map(
            lambda t: jnp.full_like(t, 0.25), jp))
    for a, b in zip(tree_leaves(new_s["err"]), tree_leaves(red)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(new_p), jax.tree_util.tree_leaves(ref_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("script,args,expect", [
    ("torch_quickstart.py", ["--device", "cpu"], "streaming early-exit"),
    ("torch_train_denoiser.py", ["--steps", "20", "--device", "cpu"],
     "[sample] CHORDS K=8"),
    ("torch_serve_diffusion.py", ["--device", "cpu", "--steps", "20",
                                  "--requests", "4"],
     "outputs identical across engines"),
])
def test_example_runs_on_cpu(tmp_path, script, args, expect):
    if script == "torch_train_denoiser.py":
        args = args + ["--ckpt-dir", str(tmp_path / "ck")]
    # a few threads: the suite runs in parallel workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout
    if script == "torch_train_denoiser.py":
        assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000020"]
