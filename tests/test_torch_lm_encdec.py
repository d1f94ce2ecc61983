"""Enc-dec (``seamless-m4t-medium``) through ``repro_torch.serve`` against
``repro.serve.steps`` on the CPU (reduced config, f32). Weights from the
JAX package's ``init_model`` with every norm weight drawn off 1, loaded
with ``load_jax_params``; a prompt of 12 ids and source frames [2, 8, D]
from a numpy seed.

- the config field by field and the parameter tree name for name;
- prefill logits within 2e-5; the bf16 cache (self ``k``/``v``, cross
  ``ck``/``cv``) within one bf16 ulp (the f32 values of the two packages
  may round to neighbouring bf16 values), dtypes equal, ``len`` exact;
- 8 decode steps teacher-forced on the reference's greedy tokens (the
  cross-attention reads the bf16 ``ck``/``cv`` with an f32 query): logits
  within 1e-3, the cache within 1e-3 or one ulp, dtypes equal;
- the port's greedy tokens (prefill, then its own argmax fed back) equal
  the reference's; ``greedy_generate`` refuses enc-dec, as the
  reference's cannot run it;
- the denoiser trunk (``api.forward_hidden``, zero or given memory) within
  2e-5 of the reference's, and bitwise with ``use_kernels`` on the CPU;
- ``examples/torch_lm_generate.py`` runs the enc-dec branch on the CPU.
"""
import dataclasses
import functools
import importlib.util
import pathlib

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

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
B, S0, SRC, MAX_LEN, DECODE = 2, 12, 8, 32, 8
PREFILL_TOL = 2e-5
DECODE_TOL = 1e-3
NORMS = ("ln1", "ln2", "ln_x", "enc_norm", "final_norm")
CACHE = {"k": "bfloat16", "v": "bfloat16", "ck": "bfloat16",
         "cv": "bfloat16", "len": "int32"}


def _norms_off_one(tree, rng):
    """Every norm weight (``init_model`` gives ones) as 1 + 0.1·N."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _norms_off_one(v, rng)
        elif k in NORMS:
            tree[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(
                v.dtype)
    return tree


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7)


def _snapshot(cache, torch_side):
    """Every leaf as (dtype name, f32 numpy copy)."""
    if torch_side:
        return {k: (str(v.dtype).replace("torch.", ""),
                    to_numpy(v).astype(np.float32)) for k, v in cache.items()}
    return {k: (str(np.asarray(v).dtype), np.asarray(v, np.float32))
            for k, v in cache.items()}


def _assert_cache_close(ours, ref, atol, where):
    assert set(ours) == set(ref) == set(CACHE), where
    for k in ref:
        (dt, out), (rdt, r) = ours[k], ref[k]
        assert dt == rdt == CACHE[k], (where, k, dt, rdt)
        assert out.shape == r.shape, (where, k, out.shape, r.shape)
        lim = np.maximum(atol, _bf16_ulp(np.maximum(np.abs(out),
                                                    np.abs(r))))
        assert (np.abs(out - r) <= lim).all(), \
            (where, k, float(np.abs(out - r).max()))


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
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    src = rng.standard_normal((B, SRC, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, np_params, params, tparams, prompt, src


def _port_greedy(tcfg, tparams, prompt, src, teacher=None):
    """The port's prefill, then DECODE steps fed ``teacher`` [B, DECODE]
    or its own argmax: logits, cache snapshots and the tokens."""
    logits, cache = make_prefill(tcfg, MAX_LEN)(
        tparams, torch.from_numpy(prompt), torch.from_numpy(src))
    out = [(logits.numpy(), _snapshot(cache, True))]
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    toks = [torch.from_numpy(prompt), tok]
    dec = make_decode_step(tcfg)
    for i in range(DECODE):
        if teacher is not None:
            tok = torch.from_numpy(teacher[:, i:i + 1])
        logits, cache = dec(tparams, tok, cache)
        out.append((logits.numpy(), _snapshot(cache, True)))
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        toks.append(tok)
    return out, torch.cat(toks, dim=1).numpy()


@functools.lru_cache(maxsize=None)
def _run():
    """The reference's prefill and greedy decode (its own argmax fed back);
    the port teacher-forced on those tokens, and greedy on its own."""
    jcfg, tcfg, _, params, tparams, prompt, src = _setup()
    jl, jcache = jsteps.make_prefill(jcfg, MAX_LEN)(
        params, jnp.asarray(prompt), jnp.asarray(src))
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
        ours, _ = _port_greedy(tcfg, tparams, prompt, src, jtoks[:, S0:])
        _, ttoks = _port_greedy(tcfg, tparams, prompt, src)
    return ref, ours, jtoks, ttoks


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_jax_field_by_field(reduced):
    ours, ref = get_config(ARCH, reduced=reduced), \
        j_get_config(ARCH, reduced=reduced)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_param_tree_matches_jax():
    _, _, np_params, _, tparams, _, _ = _setup()
    assert {n: tuple(p.shape) for n, p in tparams.named_parameters()} == \
        _flat(np_params)
    assert api.param_count(get_config(ARCH)) == \
        japi.param_count(j_get_config(ARCH))


def test_prefill_logits_and_cache():
    (rl, rc), (ol, oc) = _run()[0][0], _run()[1][0]
    assert ol.shape == rl.shape == (B, S0, 256)
    np.testing.assert_allclose(ol, rl, rtol=0, atol=PREFILL_TOL)
    _assert_cache_close(oc, rc, PREFILL_TOL, "prefill")
    assert oc["ck"][1].shape[2] == SRC
    assert (oc["len"][1] == S0).all()
    assert not oc["k"][1][:, :, S0:].any()  # zeros past the prompt


def test_decode_teacher_forced():
    ref, ours = _run()[:2]
    for i, ((rl, rc), (ol, oc)) in enumerate(zip(ref[1:], ours[1:])):
        assert ol.shape == rl.shape == (B, 1, 256)
        np.testing.assert_allclose(ol, rl, rtol=0, atol=DECODE_TOL)
        _assert_cache_close(oc, rc, DECODE_TOL, f"step {i}")
        np.testing.assert_array_equal(oc["len"][1], S0 + i + 1)


def test_greedy_tokens():
    _, _, jtoks, ttoks = _run()
    assert ttoks.shape == jtoks.shape == (B, S0 + DECODE + 1)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_greedy_generate_refuses_encdec():
    _, tcfg, _, _, tparams, prompt, _ = _setup()
    with pytest.raises(ValueError, match="enc-dec"):
        greedy_generate(tcfg, tparams, torch.from_numpy(prompt), 2, MAX_LEN)


@pytest.mark.parametrize("memory", [None, "given"])
def test_denoiser_trunk_matches_jax(memory):
    """``api.forward_hidden``: the decoder stack over zero memory [B, 16,
    D] (or a given one) and the final norm; the kernel flag is bitwise on
    the CPU."""
    jcfg, tcfg, _, params, tparams, _, _ = _setup()
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((B, 16, jcfg.d_model)).astype(np.float32)
    kw = {}
    if memory == "given":
        kw["memory"] = rng.standard_normal((B, 6, jcfg.d_model)).astype(
            np.float32)
    ref = np.asarray(japi.forward_hidden(
        params, jcfg, jnp.asarray(emb),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        outs = [api.forward_hidden(
            tparams, tcfg.replace(use_kernels=uk), torch.from_numpy(emb),
            causal=False, **{k: torch.from_numpy(v) for k, v in kw.items()})
            for uk in (False, True)]
    assert outs[0].shape == ref.shape == emb.shape
    np.testing.assert_allclose(outs[0].numpy(), ref, rtol=0,
                               atol=PREFILL_TOL)
    assert torch.equal(outs[0], outs[1])


def test_example_runs_the_encdec_branch(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_lm_generate", ROOT / "examples" / "torch_lm_generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--arch", ARCH, "--device", "cpu", "--gen-steps", "4"])
    assert tuple(out.shape) == (2, 8 + 4)
    assert "enc-dec" in capsys.readouterr().out
