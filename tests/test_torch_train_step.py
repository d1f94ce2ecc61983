"""``repro_torch.train.make_train_step`` against the JAX package's
``make_train_step`` on the CPU: reduced ``qwen1.5-0.5b`` (f32), weights
from the JAX package's ``init_model`` (norm weights drawn off 1), three
chained steps on the reference ``DataPipeline``'s batches (B 4 × S 16),
at 1 and 2 microbatches, with and without ``compress_grads`` (the local
error-feedback model; no mesh).

Limits: the loss within 1e-5 relative; ``grad_norm`` within 1e-6
relative; ``lr`` exact against the reference's ``lr_at`` and within 1e-6
of the jitted reference step's (XLA fuses the schedule's product there:
one f32 ulp at step 2); ``w32``, ``m``, ``v`` (and ``err``) and the
params within 1e-5 relative per leaf in the L2 norm (``||out - ref|| <=
1e-5 ||ref||``, the per-leaf measure of ``tests/test_torch_train.py``;
at most 2.5e-6 here, where the largest elementwise gap of the zero-born
bias leaves reads up to 1.4e-5 of their largest element), ``step``
equal. With ``compress_grads`` the int8 quantizer turns the ~1e-6
gradient gap into one-level flips of a few elements: the residual
``err`` is held element by element (equal to 1e-3 of a level, or one
level apart at under 5 % of a leaf), and ``w32``/``m``/``v``/params to
1e-3 (5.4e-4 read). AdamW's ``eps`` is 1e-4 here, not the default 1e-8:
with 1e-8 the first update is about ``lr * sign(g)``, so a gradient
element within an ulp of zero may flip the sign of its update between
the packages; a larger ``eps`` compares the steps instead of that sign
noise. The loss and gradient limits are not loosened by it.

Inside the port: the step, which writes its update into the trees it is
given (the reference launcher donates them), is bitwise the functional
``apply_updates`` on the same gradients; the microbatched step's
gradients are f32 and the single-batch step's keep the parameter dtype;
``mesh=`` builds the mesh steps (their parity tests are
``test_torch_mesh_steps.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import DataPipeline as JPipe
from repro.models import api as japi
from repro.optim import optimizer as jopt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.optim import optimizer as topt
from repro_torch.train import make_train_step
from repro_torch.train.train_step import (batch_to, loss_and_grads,
                                          step_loss_and_grads)
from repro_torch.utils.convert import load_jax_params
from repro_torch.utils.tree import tree_leaves, tree_map

ARCH = "qwen1.5-0.5b"
B, S, STEPS = 4, 16, 3
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-4)


def _rel_close(out, ref, rel, what=""):
    """||out - ref|| <= rel * ||ref|| (L2; a scalar's relative gap)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    gap = np.linalg.norm((out - ref).ravel())
    assert gap <= rel * max(np.linalg.norm(ref.ravel()), 1e-30), (what, gap)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = j_get_config(ARCH, reduced=True)
    tcfg = get_config(ARCH, reduced=True)
    np_params = jax.tree_util.tree_map(
        np.asarray, japi.init_model(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    for sub, name in ((np_params["blocks"], "ln1"),
                      (np_params["blocks"], "ln2"),
                      (np_params, "final_norm")):
        w = sub[name]
        sub[name] = (1.0 + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)
    pipe = JPipe(jcfg, seq_len=S, global_batch=B)
    return jcfg, tcfg, np_params, [pipe(i) for i in range(STEPS)]


def _tparams(tcfg, np_params):
    return tree_map(lambda p: p.detach().clone(),
                    load_jax_params(api.init_model(tcfg, 0, device="cpu"),
                                    np_params))


@functools.lru_cache(maxsize=None)
def _runs(nm, compress):
    jcfg, tcfg, np_params, batches = _setup()
    jo = jopt.AdamWConfig(compress_grads=compress, **OPT)
    to = topt.AdamWConfig(compress_grads=compress, **OPT)
    jstep = jax.jit(j_make_train_step(jcfg, jo, num_microbatches=nm,
                                      remat=True))
    tstep = make_train_step(tcfg, to, num_microbatches=nm, remat=True)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = _tparams(tcfg, np_params)
    js, ts = jopt.init_state(jp, jo), topt.init_state(tp, to)
    out = []
    for b in batches:
        jp, js, jm = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, b))
        tp, ts, tm = tstep(tp, ts, b)
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()}))
    return out, (jp, js), (tp, ts)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("nm", [1, 2])
def test_train_steps_match_jax(nm, compress):
    metrics, (jp, js), (tp, ts) = _runs(nm, compress)
    jo = jopt.AdamWConfig(compress_grads=compress, **OPT)
    for step, (jm, tm) in enumerate(metrics):
        _rel_close(tm["loss"], jm["loss"], 1e-5, "loss")
        _rel_close(tm["grad_norm"], jm["grad_norm"], 1e-6, "grad_norm")
        # exact against the reference's schedule; its jitted step fuses
        # the schedule's product and read one f32 ulp off it at step 2
        assert tm["lr"] == float(jopt.lr_at(jo, jnp.asarray(step,
                                                            jnp.int32)))
        _rel_close(tm["lr"], jm["lr"], 1e-6, "lr")
    assert int(ts["step"]) == int(js["step"]) == STEPS
    # compress: the int8 quantizer turns the packages' ~1e-6 gradient gap
    # into a one-level flip of a few elements (below), which the moments
    # carry: up to 5.4e-4 relative L2 in m and v here
    rel = 1e-3 if compress else 1e-5
    for name in ("w32", "m", "v"):
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(js[name]),
                                       tree_leaves(ts[name]))):
            _rel_close(b.numpy(), a, rel, (name, i))
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jp),
                                   tree_leaves(tp))):
        _rel_close(b.numpy(), a, rel, ("params", i))
    if compress:
        _err_gaps_are_level_flips(jax.tree_util.tree_leaves(js["err"]),
                                  tree_leaves(ts["err"]))


def _err_gaps_are_level_flips(ref, out):
    """The error-feedback residual lies within half an int8 level of 0,
    so a leaf's level is about twice its largest residual. Each element
    equals the reference's within 1e-3 of that level (1e-5 relative to
    the quantizer's input, 127 levels wide), or differs by about one
    level (a flip), at no more than 5 % of a leaf's elements (2.3 %
    read, over three steps)."""
    for i, (a, b) in enumerate(zip(ref, out)):
        a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
        level = 2.0 * np.abs(a).max()
        gap = np.abs(a - b)
        flips = gap > 1e-3 * level
        assert flips.mean() <= 0.05, (i, flips.mean())
        assert (gap <= 1.05 * level).all(), (i, gap.max() / level)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("nm", [1, 2])
def test_donated_step_is_bitwise_the_functional_step(nm, compress):
    """The step writes into the trees it is given; the same gradients
    through the functional ``apply_updates`` give the same bits."""
    _, tcfg, np_params, batches = _setup()
    to = topt.AdamWConfig(compress_grads=compress, **OPT)
    ref_p = _tparams(tcfg, np_params)
    ref_s = topt.init_state(ref_p, to)
    for b in batches:
        _, grads = step_loss_and_grads(tcfg, ref_p, batch_to(b, "cpu"), nm,
                                       remat=True)
        with torch.no_grad():
            ref_p, ref_s, _ = topt.apply_updates(ref_p, grads, ref_s, to)
    step = make_train_step(tcfg, to, num_microbatches=nm, remat=True)
    tp = _tparams(tcfg, np_params)
    ts = topt.init_state(tp, to)
    p0, s0 = tp, ts
    for b in batches:
        tp, ts, _ = step(tp, ts, b)
    assert tp is p0 and ts is s0  # written into the given storage
    assert int(ts["step"]) == int(ref_s["step"]) == STEPS
    for a, b in zip(tree_leaves(ref_p), tree_leaves(tp)):
        assert torch.equal(a, b)
    for name in ("w32", "m", "v") + (("err",) if compress else ()):
        for a, b in zip(tree_leaves(ref_s[name]), tree_leaves(ts[name])):
            assert torch.equal(a, b)


def test_gradient_dtypes():
    """One microbatch: grads in the parameters' dtype (bf16 here); the
    microbatched step sums them in f32, as the reference's scan."""
    _, tcfg, np_params, batches = _setup()
    cfg = tcfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    tp = tree_map(lambda p: p.to(torch.bfloat16), _tparams(tcfg, np_params))
    loss, grads = loss_and_grads(cfg, tp, batch_to(batches[0], "cpu"))
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))
    seen = []
    orig = topt.apply_updates

    def spy(params, grads, *a, **kw):
        seen.extend(g.dtype for g in tree_leaves(grads))
        return orig(params, grads, *a, **kw)

    import repro_torch.train.train_step as ts_mod
    ts_mod.apply_updates = spy
    try:
        step = make_train_step(cfg, topt.AdamWConfig(**OPT),
                               num_microbatches=2)
        step(tp, topt.init_state(tp, topt.AdamWConfig(**OPT)), batches[0])
    finally:
        ts_mod.apply_updates = orig
    assert seen and all(d == torch.float32 for d in seen)


def test_mesh_raises():
    """``mesh=`` builds the mesh step (the parity tests of it and of the
    wire-compressed step are ``test_torch_mesh_steps.py``); the compressed
    wire step takes one microbatch, as the reference's, and says so for
    more."""
    _, tcfg, _, _ = _setup()
    assert callable(make_train_step(tcfg, topt.AdamWConfig(),
                                    num_microbatches=2, mesh=object()))
    with pytest.raises(NotImplementedError, match="num_microbatches == 1"):
        make_train_step(tcfg, topt.AdamWConfig(compress_grads=True),
                        num_microbatches=2, mesh=object())
    with pytest.raises(NotImplementedError, match="num_microbatches == 1"):
        j_make_train_step(j_get_config(ARCH, reduced=True),
                          jopt.AdamWConfig(compress_grads=True),
                          num_microbatches=2, mesh=object())
