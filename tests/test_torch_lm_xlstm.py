"""xLSTM (``xlstm-1.3b``) through ``repro_torch.serve`` against
``repro.serve.steps`` on the CPU (reduced config, f32). Weights from the
JAX package's ``init_model`` with every norm weight drawn off 1, loaded
with ``load_jax_params`` (the mLSTM parameters stack two leading dims
``(G, per)``); a prompt of 16 ids (two chunks of 8).

- the config field by field and the parameter tree name for name;
- prefill logits and all ten state entries within 2e-5, dtypes equal,
  ``len`` exact;
- 8 decode steps teacher-forced on the reference's greedy tokens: logits
  and every state entry within 1e-3, dtypes equal after every step;
- ``greedy_generate``'s tokens equal the reference's greedy tokens;
- the denoiser trunk (``api.forward_hidden``) within 2e-5 of the
  reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.serve import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serve import greedy_generate, make_decode_step, make_prefill
from repro_torch.utils.convert import load_jax_params, to_numpy

ARCH = "xlstm-1.3b"
B, S0, DECODE = 2, 16, 8
PREFILL_TOL = 2e-5
DECODE_TOL = 1e-3
NORMS = ("ln", "out_norm", "final_norm")
STATE = {"m_c": "float32", "m_n": "float32", "m_m": "float32",
         "m_conv": "float32", "s_c": "float32", "s_n": "float32",
         "s_m": "float32", "s_h": "float32", "s_conv": "float32",
         "len": "int32"}


def _norms_off_one(tree, rng):
    """Every norm weight (``init_model`` gives ones) as 1 + 0.1·N."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _norms_off_one(v, rng)
        elif k in NORMS:
            tree[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    return tree


def _snapshot(cache, torch_side):
    """Every leaf as (dtype name, f32 numpy copy)."""
    if torch_side:
        return {k: (str(v.dtype).replace("torch.", ""),
                    to_numpy(v).astype(np.float32)) for k, v in cache.items()}
    return {k: (str(np.asarray(v).dtype), np.asarray(v, np.float32))
            for k, v in cache.items()}


def _assert_state_close(ours, ref, atol, where):
    assert set(ours) == set(ref) == set(STATE), where
    for k in ref:
        (dt, out), (rdt, r) = ours[k], ref[k]
        assert dt == rdt == STATE[k], (where, k, dt, rdt)
        assert out.shape == r.shape, (where, k, out.shape, r.shape)
        np.testing.assert_allclose(out, r, rtol=0, atol=atol,
                                   err_msg=f"{where} {k}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = j_get_config(ARCH, reduced=True)
    tcfg = get_config(ARCH, reduced=True)
    np_params = _norms_off_one(jax.tree_util.tree_map(
        np.asarray, japi.init_model(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(2))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = load_jax_params(api.init_model(tcfg, 0, device="cpu"),
                              np_params)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    return jcfg, tcfg, np_params, params, tparams, prompt


@functools.lru_cache(maxsize=None)
def _run():
    """The reference's prefill and greedy decode (its own argmax fed back);
    the port teacher-forced on those tokens; the port's greedy_generate."""
    jcfg, tcfg, _, params, tparams, prompt = _setup()
    jl, jcache = jsteps.make_prefill(jcfg, S0 + DECODE)(params,
                                                        jnp.asarray(prompt))
    ref = [(np.asarray(jl), _snapshot(jcache, False))]
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    toks = [np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)]
    for _ in range(DECODE):
        jl, jcache = jdec(params, jnp.asarray(toks[-1]), jcache)
        ref.append((np.asarray(jl), _snapshot(jcache, False)))
        toks.append(np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(
            np.int32))
    jtoks = np.concatenate([prompt] + toks, axis=1)
    with torch.no_grad():
        logits, cache = make_prefill(tcfg, S0 + DECODE)(
            tparams, torch.from_numpy(prompt))
        ours = [(logits.numpy(), _snapshot(cache, True))]
        dec = make_decode_step(tcfg)
        for i in range(DECODE):
            logits, cache = dec(tparams, torch.from_numpy(
                jtoks[:, S0 + i:S0 + i + 1]), cache)
            ours.append((logits.numpy(), _snapshot(cache, True)))
        ttoks = greedy_generate(tcfg, tparams, torch.from_numpy(prompt),
                                DECODE + 1, S0 + DECODE + 1).numpy()
    return ref, ours, jtoks, ttoks


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(reduced):
    ours, ref = get_config(ARCH, reduced=reduced), \
        j_get_config(ARCH, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_param_tree_matches_jax():
    jcfg, tcfg, np_params, _, tparams, _ = _setup()
    assert {n: tuple(p.shape) for n, p in tparams.named_parameters()} == \
        _flat(np_params)
    assert tparams["mlstm"]["w_q"].shape[:2] == (2, 1)  # (G, per)
    assert api.param_count(get_config(ARCH)) == \
        japi.param_count(j_get_config(ARCH))


def test_prefill_logits_and_state():
    (rl, rc), (ol, oc) = _run()[0][0], _run()[1][0]
    assert ol.shape == rl.shape == (B, S0, 256)
    np.testing.assert_allclose(ol, rl, rtol=0, atol=PREFILL_TOL)
    _assert_state_close(oc, rc, PREFILL_TOL, "prefill")
    assert (oc["len"][1] == S0).all()


def test_decode_teacher_forced():
    ref, ours = _run()[:2]
    for i, ((rl, rc), (ol, oc)) in enumerate(zip(ref[1:], ours[1:])):
        assert ol.shape == rl.shape == (B, 1, 256)
        np.testing.assert_allclose(ol, rl, rtol=0, atol=DECODE_TOL)
        _assert_state_close(oc, rc, DECODE_TOL, f"step {i}")
        np.testing.assert_array_equal(oc["len"][1], S0 + i + 1)


def test_greedy_tokens():
    _, _, jtoks, ttoks = _run()
    assert ttoks.shape == jtoks.shape == (B, S0 + DECODE + 1)
    np.testing.assert_array_equal(ttoks, jtoks)


@pytest.mark.parametrize("causal", [True, False])
def test_denoiser_trunk_matches_jax(causal):
    """``api.forward_hidden`` as a denoiser trunk: the recurrence runs
    causally whatever ``causal`` says, in both packages."""
    jcfg, tcfg, _, params, tparams, _ = _setup()
    emb = np.random.default_rng(4).standard_normal(
        (B, 16, jcfg.d_model)).astype(np.float32)
    ref = np.asarray(japi.forward_hidden(params, jcfg, jnp.asarray(emb),
                                         causal=causal))
    with torch.no_grad():
        out = api.forward_hidden(tparams, tcfg, torch.from_numpy(emb),
                                 causal=causal).numpy()
    assert out.shape == ref.shape == emb.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=PREFILL_TOL)
