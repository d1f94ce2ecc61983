"""The LM training path of the port (``forward_train`` of every family,
``api.lm_loss``, remat, the eval step) against the JAX package on the CPU,
one reduced config (f32) per family. Weights come from the JAX package's
``init_model`` with every norm weight drawn off 1, loaded with
``load_jax_params``; batches from the reference's ``DataPipeline``
(B 4 × S 16, enc-dec source frames [4, 4, 64]).

Tolerances:

- the loss within 1e-6 relative of ``repro.models.api.lm_loss``;
- every gradient leaf by ``torch.autograd`` within 1e-5 relative of
  ``jax.grad``'s in the L2 norm (``||g_port - g_jax|| <= 1e-5 ||g_jax||``,
  the limit of ``tests/test_torch_train.py``); every family holds it;
- ``remat=True`` against ``remat=False``: loss and grads bitwise;
- the loss with ``use_kernels`` under autograd raises (the kernels have no
  backward); the eval step with ``use_kernels`` is bitwise its plain run
  on the CPU;
- labels padded with -100 are masked as in the reference, and a batch of
  padding only gives 0 (the sum over ``max(count, 1)``).
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
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.train import make_eval_step
from repro_torch.utils.convert import load_jax_params
from repro_torch.utils.tree import tree_leaves, tree_map

ARCHS = ("qwen1.5-0.5b", "qwen2-vl-7b", "olmoe-1b-7b", "zamba2-2.7b",
         "xlstm-1.3b", "seamless-m4t-medium")
B, S = 4, 16
NORMS = ("ln", "ln_in", "ln1", "ln2", "ln_x", "gate_norm", "out_norm",
         "final_norm", "enc_norm")
LOSS_REL, GRAD_REL = 1e-6, 1e-5


def _norms_off_one(tree, rng):
    """Every norm weight (``init_model`` gives ones) as 1 + 0.1·N."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _norms_off_one(v, rng)
        elif k in NORMS:
            tree[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    np_params = _norms_off_one(jax.tree_util.tree_map(
        np.asarray, japi.init_model(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(2))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = load_jax_params(api.init_model(tcfg, 0, device="cpu"),
                              np_params)
    batch = JPipe(jcfg, seq_len=S, global_batch=B)(3)
    return jcfg, tcfg, params, tparams, batch


def _padded(batch):
    """The batch with the last 5 labels of row 0 and the first 3 of row 2
    set to -100."""
    labels = batch["labels"].copy()
    labels[0, -5:] = -100
    labels[2, :3] = -100
    return dict(batch, labels=labels)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _trainable(tparams):
    return tree_map(lambda p: p.detach().clone().requires_grad_(), tparams)


def _grads(tcfg, tparams, batch, **fw):
    p = _trainable(tparams)
    loss = api.lm_loss(p, tcfg, _torch_batch(batch), **fw)
    return loss.detach(), torch.autograd.grad(
        loss, tree_leaves(p), allow_unused=True, materialize_grads=True)


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The reference's loss and gradients, jitted once an arch (the padded
    and unpadded batches share its shapes)."""
    jcfg = _setup(arch)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: japi.lm_loss(p, jcfg, b)))


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, padded):
    _, _, params, _, batch = _setup(arch)
    batch = _padded(batch) if padded else batch
    loss, g = _jax_step(arch)(params,
                              jax.tree_util.tree_map(jnp.asarray, batch))
    return float(loss), [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


@functools.lru_cache(maxsize=None)
def _port_grads(arch, remat):
    _, tcfg, _, tparams, batch = _setup(arch)
    return _grads(tcfg, tparams, batch, remat=remat)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch, padded):
    _, tcfg, _, tparams, batch = _setup(arch)
    batch = _padded(batch) if padded else batch
    ref, _ = _jax_value_and_grad(arch, padded)
    with torch.no_grad():
        out = float(api.lm_loss(tparams, tcfg, _torch_batch(batch)))
    assert abs(out - ref) <= LOSS_REL * abs(ref), (out, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    _, ref = _jax_value_and_grad(arch, False)
    loss, grads = _port_grads(arch, True)
    assert len(grads) == len(ref)
    for i, (a, b) in enumerate(zip(ref, grads)):
        assert a.shape == tuple(b.shape), i
        a, b = a.astype(np.float64), b.numpy().astype(np.float64)
        assert np.linalg.norm(b - a) <= GRAD_REL * np.linalg.norm(a), \
            (i, np.linalg.norm(b - a) / np.linalg.norm(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise(arch):
    (l1, g1), (l0, g0) = _port_grads(arch, True), _port_grads(arch, False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_kernels_under_autograd_raises(arch):
    _, tcfg, _, tparams, batch = _setup(arch)
    with pytest.raises(ValueError, match="no backward"):
        api.lm_loss(_trainable(tparams), tcfg.replace(use_kernels=True),
                    _torch_batch(batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_with_kernels_is_bitwise_on_cpu(arch):
    _, tcfg, _, tparams, batch = _setup(arch)
    tb = _torch_batch(_padded(batch))
    plain = make_eval_step(tcfg)(tparams, tb)
    kern = make_eval_step(tcfg.replace(use_kernels=True))(
        _trainable(tparams), tb)  # no_grad inside: trainable leaves pass
    assert torch.equal(plain, kern)
    ref, _ = _jax_value_and_grad(arch, True)
    assert abs(float(plain) - ref) <= LOSS_REL * abs(ref)


def test_padding_only_gives_zero():
    _, tcfg, _, tparams, batch = _setup("qwen1.5-0.5b")
    tb = _torch_batch(batch)
    tb["labels"] = torch.full_like(tb["labels"], -100)
    with torch.no_grad():
        assert float(api.lm_loss(tparams, tcfg, tb)) == 0.0


def test_vlm_forward_train_takes_positions_and_embeds():
    """qwen2-vl's ``forward_train`` with M-RoPE positions [3, B, S] (not
    all-text) and patch embeddings, against the reference's."""
    from repro.models import dense as jdense
    from repro_torch.models import dense
    jcfg, tcfg, params, tparams, batch = _setup("qwen2-vl-7b")
    rng = np.random.default_rng(5)
    pos = np.cumsum(rng.integers(0, 2, (3, B, S)), axis=-1).astype(np.int32)
    emb = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    ref = np.asarray(jdense.forward_train(
        params, jcfg, jnp.asarray(batch["tokens"]), positions=jnp.asarray(pos),
        embeds=jnp.asarray(emb)))
    with torch.no_grad():
        out = dense.forward_train(tparams, tcfg,
                                  torch.from_numpy(batch["tokens"]),
                                  positions=torch.from_numpy(pos),
                                  embeds=torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b",
                                  "xlstm-1.3b"])
def test_unbound_layers_give_the_sliced_layers_gradients(arch, monkeypatch):
    """``dense._layers`` (one unbind a leaf) against slicing layer by
    layer (``leaf[i]`` for layer ``i``): the same loss and gradients,
    bitwise."""
    _, tcfg, _, tparams, batch = _setup(arch)
    loss, grads = _port_grads(arch, True)

    def layer(blocks, i):
        return {k: v[i] if isinstance(v, torch.Tensor) else layer(v, i)
                for k, v in blocks.items()}

    def sliced(blocks):
        n = tree_leaves(blocks)[0].shape[0]
        return [layer(blocks, i) for i in range(n)]

    for mod in ("dense", "encdec", "zamba2", "xlstm"):
        monkeypatch.setattr(f"repro_torch.models.{mod}._layers", sliced)
    loss2, grads2 = _grads(tcfg, tparams, batch, remat=True)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
