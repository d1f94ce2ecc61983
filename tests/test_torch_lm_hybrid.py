"""The zamba2 hybrid as an LM through ``repro_torch.serve`` against
``repro.serve.steps`` on the CPU (reduced config, f32; the reference runs
with ``use_kernels=False``). Weights from the JAX package's ``init_model``
with every norm weight drawn off 1, loaded with ``load_jax_params``; a
prompt of 16 ids (two SSD chunks of 8).

- prefill logits within 2e-5 (the f32 contract); every cache entry with
  the reference's dtype, the f32 ones (``ssm``) within 2e-5, the bf16 ones
  (``conv``, ``k``, ``v``) within one bf16 ulp (the f32 values of the two
  packages may round to neighbouring bf16 values); ``len`` exact;
- 8 decode steps teacher-forced on the reference's greedy tokens: logits
  and every cache entry within 1e-3 (bf16 entries: or one ulp), dtypes
  equal after every step (``conv`` comes back f32, as the reference's
  concatenate promotes it), ``len`` exact;
- ``greedy_generate``'s tokens equal the reference's greedy tokens;
- with ``use_kernels=True`` the CPU run is bitwise the plain one.
"""
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
from repro_torch.models import api
from repro_torch.serve import greedy_generate, make_decode_step, make_prefill
from repro_torch.utils.convert import load_jax_params, to_numpy

ARCH = "zamba2-2.7b"
B, S0, MAX_LEN, DECODE = 2, 16, 32, 8
PREFILL_TOL = 2e-5
DECODE_TOL = 1e-3
NORMS = ("ln", "ln_in", "ln1", "ln2", "gate_norm", "final_norm")


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


def _j_dtype(x):
    return str(np.asarray(x).dtype)


def _t_dtype(t):
    return str(t.dtype).replace("torch.", "")


def _snapshot(cache, torch_side):
    """Every leaf as (dtype name, f32 numpy copy)."""
    if torch_side:
        return {k: (_t_dtype(v), to_numpy(v).astype(np.float32))
                for k, v in cache.items()}
    return {k: (_j_dtype(v), np.asarray(v, np.float32))
            for k, v in cache.items()}


def _assert_cache_close(ours, ref, atol, where):
    assert set(ours) == set(ref), where
    for k in ref:
        (dt, out), (rdt, r) = ours[k], ref[k]
        assert dt == rdt, (where, k, dt, rdt)
        assert out.shape == r.shape, (where, k, out.shape, r.shape)
        gap = np.abs(out - r)
        lim = atol
        if rdt == "bfloat16":
            lim = np.maximum(atol, _bf16_ulp(np.maximum(np.abs(out),
                                                        np.abs(r))))
        assert (gap <= lim).all(), (where, k, float(gap.max()))


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
    return jcfg, tcfg, params, tparams, prompt


def _port_run(tcfg, tparams, prompt, teacher):
    """The port's prefill and DECODE steps fed ``teacher`` [B, DECODE]:
    logits and a cache snapshot after each."""
    logits, cache = make_prefill(tcfg, MAX_LEN)(tparams,
                                                torch.from_numpy(prompt))
    out = [(logits.numpy(), _snapshot(cache, True))]
    dec = make_decode_step(tcfg)
    for i in range(DECODE):
        logits, cache = dec(tparams, torch.from_numpy(teacher[:, i:i + 1]),
                            cache)
        out.append((logits.numpy(), _snapshot(cache, True)))
    return out


@functools.lru_cache(maxsize=None)
def _run():
    """The reference's prefill and greedy decode (its own argmax fed back);
    the port teacher-forced on those tokens; the port's greedy_generate."""
    jcfg, tcfg, params, tparams, prompt = _setup()
    jl, jcache = jsteps.make_prefill(jcfg, MAX_LEN)(params,
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
        ours = _port_run(tcfg, tparams, prompt, jtoks[:, S0:])
        ttoks = greedy_generate(tcfg, tparams, torch.from_numpy(prompt),
                                DECODE + 1, MAX_LEN).numpy()
    return ref, ours, jtoks, ttoks


def test_prefill_logits_and_cache():
    (rl, rc), (ol, oc) = _run()[0][0], _run()[1][0]
    assert ol.shape == rl.shape == (B, S0, 256)
    np.testing.assert_allclose(ol, rl, rtol=0, atol=PREFILL_TOL)
    _assert_cache_close(oc, rc, PREFILL_TOL, "prefill")
    assert {k: d for k, (d, _) in oc.items()} == {
        "conv": "bfloat16", "ssm": "float32", "k": "bfloat16",
        "v": "bfloat16", "len": "int32"}
    assert (oc["len"][1] == S0).all()
    assert not oc["k"][1][:, :, S0:].any()  # zeros past the prompt


def test_decode_teacher_forced():
    ref, ours = _run()[:2]
    for i, ((rl, rc), (ol, oc)) in enumerate(zip(ref[1:], ours[1:])):
        assert ol.shape == rl.shape == (B, 1, 256)
        np.testing.assert_allclose(ol, rl, rtol=0, atol=DECODE_TOL)
        _assert_cache_close(oc, rc, DECODE_TOL, f"step {i}")
        np.testing.assert_array_equal(oc["len"][1], S0 + i + 1)
    assert ours[-1][1]["conv"][0] == "float32"


def test_greedy_tokens():
    _, ours, jtoks, ttoks = _run()
    assert ttoks.shape == jtoks.shape == (B, S0 + DECODE + 1)
    np.testing.assert_array_equal(ttoks, jtoks)


def test_kernel_routes_bitwise_on_cpu():
    _, tcfg, _, tparams, prompt = _setup()
    _, _, jtoks, _ = _run()
    with torch.no_grad():
        plain = _port_run(tcfg, tparams, prompt, jtoks[:, S0:])
        kern = _port_run(tcfg.replace(use_kernels=True), tparams, prompt,
                         jtoks[:, S0:])
    for (pl, pc), (kl, kc) in zip(plain, kern):
        assert np.array_equal(pl, kl)
        for k in pc:
            assert pc[k][0] == kc[k][0] and np.array_equal(pc[k][1],
                                                           kc[k][1]), k


@pytest.mark.parametrize("bad", ["ragged", "full"])
def test_decode_refuses_what_the_reference_cannot_write(bad):
    _, tcfg, _, tparams, prompt = _setup()
    with torch.no_grad():
        _, cache = make_prefill(tcfg, S0)(tparams, torch.from_numpy(prompt))
        if bad == "ragged":
            cache["len"][1] -= 1
        tok = torch.zeros((B, 1), dtype=torch.int32)
        with pytest.raises(ValueError, match="differ" if bad == "ragged"
                           else "full"):
            make_decode_step(tcfg)(tparams, tok, cache)
