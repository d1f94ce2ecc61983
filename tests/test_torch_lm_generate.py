"""LM serving through ``repro_torch.serve`` against ``repro.serve.steps``
on the CPU, for the seven LM configs (reduced, f32), weights from the JAX
package's ``init_model`` with the norm weights drawn off 1, loaded with
``load_jax_params``:

- prefill logits within 2e-5 (the f32 attention contract);
- the bf16 KV cache within one bf16 ulp (the f32 k/v of the two packages
  may round to neighbouring bf16 values);
- 8 decode steps, teacher-forced on the JAX package's greedy tokens, within
  1e-3: both read the same bf16 cache to within one ulp, and the gap reads
  at most 7.6e-6 on the CPU; an off-by-one decode mask or a cache write
  one position off fails it;
- ``greedy_generate``'s tokens equal the JAX package's, row by row up to a
  step whose top-2 logit margin (the JAX package's) is within twice that
  step's tolerance (each of the two logits may move by it); the smallest
  margin is printed (``-s``);
- the VLM's prefill from ``embeds=``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from repro.models import dense as jdense
from repro.serve import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import api, dense
from repro_torch.serve import greedy_generate, make_decode_step, make_prefill
from repro_torch.utils.convert import load_jax_params, to_numpy, to_torch

LM_ARCHS = ("qwen1.5-0.5b", "qwen1.5-32b", "gemma-7b", "internlm2-1.8b",
            "qwen2-vl-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")
B, S0, MAX_LEN, DECODE = 2, 12, 32, 8
PREFILL_TOL = 2e-5
DECODE_TOL = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _norms_off_one(tree):
    """The norm weights (``init_model`` gives ones) drawn as 1 + 0.1·N, so
    that the comparisons exercise the weight path of every norm."""
    rng = np.random.default_rng(2)
    for sub, name in ((tree["blocks"], "ln1"), (tree["blocks"], "ln2"),
                      (tree, "final_norm")):
        w = sub[name]
        sub[name] = (1.0 + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    np_params = _norms_off_one(_np_tree(japi.init_model(
        jcfg, jax.random.PRNGKey(0))))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = load_jax_params(api.init_model(tcfg, 0, device="cpu"),
                              np_params)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    return jcfg, tcfg, params, tparams, prompt


@functools.lru_cache(maxsize=None)
def _run(arch):
    """Both packages: prefill, then DECODE steps fed the JAX package's
    greedy tokens; and greedy_generate of both."""
    jcfg, tcfg, params, tparams, prompt = _setup(arch)
    jtoks = np.asarray(jsteps.greedy_generate(
        jcfg, params, jnp.asarray(prompt), DECODE + 1, MAX_LEN))
    ttoks = greedy_generate(tcfg, tparams, torch.from_numpy(prompt),
                            DECODE + 1, MAX_LEN).numpy()
    jl, jcache = jsteps.make_prefill(jcfg, MAX_LEN)(params, jnp.asarray(prompt))
    tl, tcache = make_prefill(tcfg, MAX_LEN)(tparams, torch.from_numpy(prompt))
    out = {"prefill": (np.asarray(jl), tl.numpy()),
           "cache": (np.asarray(jcache["k"], np.float32),
                     np.asarray(jcache["v"], np.float32),
                     to_numpy(tcache["k"]), to_numpy(tcache["v"]),
                     np.asarray(jcache["len"]), tcache["len"].numpy().copy()),
           "decode": [], "tokens": (jtoks, ttoks)}
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tdec = make_decode_step(tcfg)
    for i in range(DECODE):
        tok = jtoks[:, S0 + i:S0 + i + 1]
        jl, jcache = jdec(params, jnp.asarray(tok), jcache)
        tl, tcache = tdec(tparams, torch.from_numpy(tok), tcache)
        out["decode"].append((np.asarray(jl), tl.numpy()))
    out["decode_len"] = (np.asarray(jcache["len"]), tcache["len"].numpy())
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_logits(arch):
    ref, out = _run(arch)["prefill"]
    assert out.shape == (B, S0, j_get_config(arch, reduced=True).vocab_size)
    np.testing.assert_allclose(out, ref, atol=PREFILL_TOL)


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_cache_within_one_bf16_ulp(arch):
    jk, jv, tk, tv, jlen, tlen = _run(arch)["cache"]
    np.testing.assert_array_equal(tlen, jlen)
    for ref, out in ((jk, tk), (jv, tv)):
        assert out.shape == ref.shape
        assert not out[:, :, S0:].any()  # zeros past the prompt
        gap = np.abs(out - ref)
        assert (gap <= _bf16_ulp(np.maximum(np.abs(out), np.abs(ref)))).all(), \
            float(gap.max())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_teacher_forced(arch):
    run = _run(arch)
    for ref, out in run["decode"]:
        assert out.shape == ref.shape == (B, 1, ref.shape[-1])
        np.testing.assert_allclose(out, ref, rtol=0, atol=DECODE_TOL)
    jlen, tlen = run["decode_len"]
    np.testing.assert_array_equal(tlen, jlen)
    assert (tlen == S0 + DECODE).all()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_greedy_tokens(arch):
    run = _run(arch)
    jtoks, ttoks = run["tokens"]
    assert ttoks.shape == jtoks.shape == (B, S0 + DECODE + 1)
    np.testing.assert_array_equal(ttoks[:, :S0], jtoks[:, :S0])
    # the JAX package's logits at each generated token, and its tolerance
    steps = [(run["prefill"][0][:, -1], 2 * PREFILL_TOL)] + [
        (ref[:, -1], 2 * DECODE_TOL) for ref, _ in run["decode"]]
    smallest = np.inf
    for row in range(B):
        for i, (logits, tol) in enumerate(steps):
            top2 = np.sort(logits[row])[-2:]
            margin = float(top2[1] - top2[0])
            smallest = min(smallest, margin / tol)
            if ttoks[row, S0 + i] != jtoks[row, S0 + i]:
                assert margin <= tol, (row, i, margin, tol)
                break  # the rows' prefixes differ from here on
    print(f"[{arch}] greedy: smallest top-2 margin {smallest:.3e} of tol")


def test_vlm_prefill_from_embeds():
    jcfg, tcfg, params, tparams, prompt = _setup("qwen2-vl-7b")
    emb = np.random.default_rng(4).standard_normal(
        (B, S0, jcfg.d_model)).astype(np.float32)
    jl, jcache = jdense.prefill(params, jcfg, jnp.asarray(prompt), MAX_LEN,
                                embeds=jnp.asarray(emb))
    tl, tcache = dense.prefill(tparams, tcfg, torch.from_numpy(prompt),
                               MAX_LEN, embeds=to_torch(emb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=PREFILL_TOL)
    gap = np.abs(to_numpy(tcache["k"]) - np.asarray(jcache["k"], np.float32))
    assert (gap <= _bf16_ulp(np.asarray(jcache["k"], np.float32))
            + _bf16_ulp(to_numpy(tcache["k"]))).all()
