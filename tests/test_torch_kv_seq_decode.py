"""Decode over a KV cache split along its sequence: reduced dense
(``qwen1.5-0.5b``), zamba2 (its shared attention) and enc-dec
(``seamless-m4t-medium``: its decoder's self-attention, 8 source frames)
at batch 1 under ``SERVE_RULES`` on ``(data 2, model 2)`` and
``(data 4, model 1)``.
The batch cannot take ``data``, which falls back to the caches'
``kv_seq``: each rank holds a block of every cache's positions, and
``layers.attend_decode`` reduces the softmax across the blocks (max,
denominator and the PV product's partial sums all-reduced over ``data``)
where it used to gather the cache.

One module fixture runs both sides once, at the same time, in
subprocesses: ``test_torch_mesh_ranks.py``'s job ``kv_seq`` (the port on
four gloo ranks and on one device) and :func:`_jax_side` (the reference's
``repro.serve.steps`` on four fake CPU devices). A prefill of 16 tokens,
then 6 greedy decode steps, into a cache of 32 positions.

- Greedy tokens: the mesh's equal the reference's and one device's.
- Logits within 1e-3 of the reference's, within 1e-5 of one device's
  (the decode steps' from the mesh's prefill cache).
- No decode step moves a k or v (self-attention) cache block; over
  ``data`` the steps all-reduce only the merge, B·H·(Dh + 2) f32 an
  attention layer. (Enc-dec's cross-attention cache, split alike, is
  still gathered: its decode attends through ``layers.attend``, which
  keeps the memory whole.)
- ``attend_decode`` alone, with per-row lengths that leave whole blocks
  masked and with a host length: finite, within 1e-6 of one device.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from test_torch_lm_serve_mesh import _np_params
from test_torch_mesh_ranks import (KV_SEQ_ATTN, KV_SEQ_B, KV_SEQ_LENS,
                                   KV_SEQ_RUNS, LM_DECODE, LM_S0, lm_max_len,
                                   start_jax, start_job, wait_all)

KEYS = [key for key, _, _ in KV_SEQ_RUNS]
MESH = {key: shape for key, _, shape in KV_SEQ_RUNS}
ARCH = {key: arch for key, arch, _ in KV_SEQ_RUNS}
REF_TOL, ONE_TOL = 1e-3, 1e-5


def _jax_side(io_dir):
    """The reference's steps on each run's mesh (in a subprocess)."""
    from repro.dist.sharding import SERVE_RULES, tree_shardings, use_sharding
    from repro.launch.mesh import make_mesh
    from repro.models import api as japi
    from repro.serve import steps
    from repro.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    for key, arch, shape in KV_SEQ_RUNS:
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
            logits, cache = steps.make_prefill(cfg, lm_max_len(LM_S0))(
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
    io_dir = str(tmp_path_factory.mktemp("kv_seq"))
    rng = np.random.default_rng(3)
    archs = sorted(set(ARCH.values()))
    inp = {"params": {a: _np_params(a) for a in archs},
           "prompt": {key: rng.integers(
               0, j_get_config(ARCH[key], reduced=True).vocab_size,
               (KV_SEQ_B, LM_S0)).astype(np.int32) for key in KEYS},
           "src": {a: rng.standard_normal(
               (KV_SEQ_B, 8, j_get_config(a, reduced=True).d_model)
           ).astype(np.float32) for a in archs
               if j_get_config(a, reduced=True).family == "encdec"}}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    wait_all(io_dir, [
        start_job("kv_seq", io_dir),
        start_jax("from test_torch_kv_seq_decode import _jax_side; "
                  f"_jax_side({io_dir!r})", io_dir, devices=4)])
    with open(os.path.join(io_dir, "kv_seq.pkl"), "rb") as f:
        port = pickle.load(f)
    with open(os.path.join(io_dir, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    return port, ref


def _logits(run):
    return [run["prefill"]] + list(run["decode"])


@pytest.mark.parametrize("key", KEYS)
def test_cache_is_split_along_its_sequence(runs, key):
    """Every self-attention k/v cache leaf holds a quarter or a half of
    the 32 positions a rank: the layout the tests are about."""
    port, _ = runs
    blocks = port[key]["mesh"]["blocks"]
    ways = MESH[key][0]
    for name in ("k", "v"):
        assert blocks[name][:2] == (KV_SEQ_B, lm_max_len(LM_S0) // ways)


@pytest.mark.parametrize("key", KEYS)
def test_greedy_tokens(runs, key):
    port, ref = runs
    mesh, one = port[key]["mesh"], port[key]["one"]
    assert mesh["tokens"].shape == (KV_SEQ_B, LM_S0 + LM_DECODE + 1)
    np.testing.assert_array_equal(mesh["tokens"], ref[key]["tokens"])
    np.testing.assert_array_equal(mesh["tokens"], one["tokens"])


@pytest.mark.parametrize("key", KEYS)
def test_logits_to_the_reference(runs, key):
    port, ref = runs
    got, want = _logits(port[key]["mesh"]), _logits(ref[key])
    assert len(got) == len(want) == LM_DECODE + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=REF_TOL)


@pytest.mark.parametrize("key", KEYS)
def test_logits_to_one_device(runs, key):
    """The prefill's logits against one device's prefill, and each decode
    step's against one device's decode step from the mesh's own prefill
    cache (fed the same tokens). zamba2's prefill on (2, 2) rounds a few
    bf16 cache entries to the other neighbour (its tensor-parallel sums
    over ``model`` run in another order; as much with the cache gathered
    as with it split), which alone moves the next logits by ~4e-5: the
    decode steps are held to one device from the same cache."""
    port, _ = runs
    mesh = port[key]["mesh"]
    np.testing.assert_allclose(mesh["prefill"], port[key]["one"]["prefill"],
                               rtol=0, atol=ONE_TOL)
    assert len(port[key]["resumed"]) == LM_DECODE
    for g, w in zip(mesh["decode"], port[key]["resumed"]):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=ONE_TOL)


def _moves_a_block(shapes, blocks):
    """Whether a collective's input shapes hold a cache block (in any
    order of its dims)."""
    return any(sorted(s) == sorted(b) for s in shapes for b in blocks)


@pytest.mark.parametrize("key", KEYS)
def test_decode_gathers_no_cache_block(runs, key):
    """No decode step moves a tensor shaped like a k or v cache block
    (in any order of its dims; self-attention's), and ``attend_decode``
    redistributes nothing. Over ``data`` the steps all-reduce only the
    merge: three tensors an attention layer (max, denominator, output)
    of B·H·(Dh + 2) f32 together, H the rank's heads."""
    port, _ = runs
    mesh = port[key]["mesh"]
    blocks = {mesh["blocks"][name] for name in ("k", "v")}
    cfg = j_get_config(ARCH[key], reduced=True)
    heads = cfg.num_heads // MESH[key][1]
    merge = KV_SEQ_B * heads * (cfg.resolved_head_dim + 2)
    assert len(mesh["shapes"]) == LM_DECODE
    for step in mesh["shapes"]:
        for op, axis, shapes in step:
            assert not _moves_a_block(shapes, blocks), (op, axis, shapes)
        reduced = [int(np.prod(s[0])) for op, axis, s in step
                   if axis == "data" and op.startswith("all_reduce")]
        assert reduced and len(reduced) % 3 == 0
        assert sum(reduced) == len(reduced) // 3 * merge
    assert "attend_decode" not in mesh["redistributes"]


@pytest.mark.parametrize("shape", sorted({s for s in MESH.values()}),
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("lens", ["lens", "host"])
def test_masked_blocks_add_nothing(runs, shape, lens):
    """``attend_decode`` alone: lengths 5 and 27 over 32 positions (on
    (4, 1) row 0's last three blocks are wholly masked; a host length of
    5 leaves three ranks nothing to read). No NaN, and within 1e-6 of one
    device; the merge's three all-reduces over ``data`` carry
    B·H·(Dh + 2) f32 in all, and ``CollectiveLog`` counts just them."""
    port, _ = runs
    r = port["attn"][shape][lens]
    b, _, kvh, g, dh = KV_SEQ_ATTN
    assert r["mesh"].shape == (b, 1, kvh * g, dh)
    assert np.isfinite(r["mesh"]).all()
    np.testing.assert_allclose(r["mesh"], r["one"], rtol=0, atol=1e-6)
    over_data = [s for op, axis, s in r["shapes"] if axis == "data"]
    h = kvh * g // shape[1]
    assert sum(int(np.prod(s[0])) for s in over_data) == b * h * (dh + 2)
    assert len(over_data) == 3
    # CollectiveLog counts the same three, and only collectives (not the
    # autograd wrap of their results)
    assert r["counts"] == {("all_reduce", "data", "float32"):
                           [3, 4 * b * h * (dh + 2), b * h * dh]}
    assert KV_SEQ_LENS[0] < KV_SEQ_ATTN[1] // 4
