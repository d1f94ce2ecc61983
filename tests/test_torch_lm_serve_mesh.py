"""LM serving on a device mesh: prefill and greedy decode of the port on
four gloo ranks of the CPU against the JAX package on four fake CPU
devices, both on a ``(data 2, model 2)`` mesh under ``SERVE_RULES``.
``zamba2-2.7b`` runs twice more: on ``(data 1, model 4)``
(``zamba2-2.7b@1x4``: its 8 SSD heads 2 a rank, the SSD layers by heads
in the prefill and every decode step), and on (2, 2) with a prompt of 64
tokens (``zamba2-2.7b@s64``: 64 tokens a rank, above ``mamba2.by_heads``'s
crossover, so the prefill's SSD layers gather their parameters and the
decode steps run by heads).

One module fixture runs both sides once, at the same time, in
subprocesses: ``test_torch_mesh_ranks.py``'s job ``lm_serve`` (the port on
the mesh and on one device) and :func:`_jax_side` (the reference's
``repro.serve.steps`` under ``use_sharding``, the parameters laid out by
``tree_shardings``). Both read the JAX package's initial parameters of
reduced ``qwen1.5-0.5b`` (dense), ``olmoe-1b-7b`` (MoE), ``zamba2-2.7b``
(the hybrid: SSD layers and a shared attention block), ``xlstm-1.3b``
(recurrent state) and ``seamless-m4t-medium`` (enc-dec, with 8 source
frames), norm weights drawn off 1, and one prompt (B 2 x S 16, or 64) a
run.

- Greedy tokens (6 generated; ``greedy_generate``, enc-dec's by the decode
  loop): the mesh's equal the reference's and the one-device port's.
- The prefill's logits and each decode step's (fed the greedy tokens)
  within 1e-3 of the reference's.
- The cache's leaves are DTensors laid out as ``cache_axes`` says under
  ``SERVE_RULES`` (batch on ``data``, kv heads, the SSD heads and the conv
  channels on ``model``); its length stays on the host.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import api as japi
from test_torch_mesh_ranks import (LM_B, LM_DECODE, LM_SRC, LM_SERVE_ARCHS,
                                   LM_SERVE_RUNS, lm_max_len, start_jax,
                                   start_job, wait_all)

KEYS = [key for key, _, _, _ in LM_SERVE_RUNS]
PROMPT = {key: s0 for key, _, _, s0 in LM_SERVE_RUNS}

LOGIT_TOL = 1e-3


def _np_params(arch):
    """The JAX package's initial parameters, every norm weight drawn as
    1 + 0.1 N so that the comparisons exercise the weights."""
    tree = jax.tree_util.tree_map(np.asarray, japi.init_model(
        j_get_config(arch, reduced=True), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)

    def walk(node):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif key.startswith(("ln", "final_norm")):
                node[key] = (1.0 + 0.1 * rng.standard_normal(val.shape)
                             ).astype(val.dtype)

    walk(tree)
    return tree


def _jax_side(io_dir):
    """The reference's steps on each run's mesh (in a subprocess)."""
    from repro.dist.sharding import SERVE_RULES, tree_shardings, use_sharding
    from repro.launch.mesh import make_mesh
    from repro.serve import steps
    from repro.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    for key, arch, shape, s0 in LM_SERVE_RUNS:
        mesh = make_mesh(shape, ("data", "model"))
        cfg = j_get_config(arch, reduced=True)
        params = jax.tree_util.tree_map(jnp.asarray, inp["params"][arch])
        params = jax.device_put(params, tree_shardings(
            pspec.logical_axes(japi.model_specs(cfg)), mesh, SERVE_RULES,
            params))
        prompt = jnp.asarray(inp["prompt"][key])
        src = inp["src"].get(arch)
        extra = () if src is None else (jnp.asarray(src),)
        with use_sharding(mesh, SERVE_RULES):
            logits, cache = steps.make_prefill(cfg, lm_max_len(s0))(
                params, prompt, *extra)
            dec = jax.jit(steps.make_decode_step(cfg))
            run = {"prefill": np.asarray(logits), "decode": []}
            toks = [jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)]
            for _ in range(LM_DECODE):
                logits, cache = dec(params, toks[-1], cache)
                run["decode"].append(np.asarray(logits))
                toks.append(jnp.argmax(logits[:, -1:], -1).astype(jnp.int32))
            run["tokens"] = np.concatenate(
                [np.asarray(prompt)] + [np.asarray(t) for t in toks], 1)
        out[key] = run
    with open(os.path.join(io_dir, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("lm_serve_mesh"))
    rng = np.random.default_rng(1)
    inp = {"params": {a: _np_params(a) for a in LM_SERVE_ARCHS},
           "prompt": {key: rng.integers(
               0, j_get_config(a, reduced=True).vocab_size,
               (LM_B, s0)).astype(np.int32)
               for key, a, _, s0 in LM_SERVE_RUNS},
           "src": {a: rng.standard_normal(
               (LM_B, LM_SRC, j_get_config(a, reduced=True).d_model)
           ).astype(np.float32) for a in LM_SERVE_ARCHS
               if j_get_config(a, reduced=True).family == "encdec"}}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    wait_all(io_dir, [
        start_job("lm_serve", io_dir),
        start_jax("from test_torch_lm_serve_mesh import _jax_side; "
                  f"_jax_side({io_dir!r})", io_dir, devices=4)])
    with open(os.path.join(io_dir, "lm_serve.pkl"), "rb") as f:
        port = pickle.load(f)
    with open(os.path.join(io_dir, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    return port, ref


@pytest.mark.parametrize("arch", KEYS)
def test_greedy_tokens_on_mesh(runs, arch):
    port, ref = runs
    mesh, one = port[arch]["mesh"], port[arch]["one"]
    assert mesh["tokens"].shape == (LM_B, PROMPT[arch] + LM_DECODE + 1)
    np.testing.assert_array_equal(mesh["tokens"], ref[arch]["tokens"])
    np.testing.assert_array_equal(mesh["tokens"], one["tokens"])


@pytest.mark.parametrize("arch", KEYS)
def test_logits_on_mesh(runs, arch):
    port, ref = runs
    mesh = port[arch]["mesh"]
    np.testing.assert_allclose(mesh["prefill"], ref[arch]["prefill"],
                               rtol=0, atol=LOGIT_TOL)
    assert len(mesh["decode"]) == len(ref[arch]["decode"]) == LM_DECODE
    for got, want in zip(mesh["decode"], ref[arch]["decode"]):
        assert got.shape == want.shape == (LM_B, 1, want.shape[-1])
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", KEYS)
def test_cache_laid_out_by_cache_axes(runs, arch):
    port, _ = runs
    got, want = port[arch]["mesh"]["cache"], port[arch]["want"]
    assert got.pop("len") == "None"  # a host array
    assert got == want
    assert any("Shard" in lay for lay in want.values())
    assert all(v == "None" for v in port[arch]["one"]["cache"].values())
