"""The LM layers of the port against ``repro.models.layers`` on the CPU,
same numpy inputs: M-RoPE within 1e-6 (distinct t/h/w rows), chunked and
decode attention within 2e-5 (the f32 attention contract), the embedding
bitwise, the unembedding within 1e-5; and ``use_kernels`` bitwise-neutral
on the CPU through prefill and decode of every LM config."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.models import api, layers
from repro_torch.serve import make_decode_step, make_prefill
from repro_torch.utils.convert import to_numpy, to_torch

LM_ARCHS = ("qwen1.5-0.5b", "qwen1.5-32b", "gemma-7b", "internlm2-1.8b",
            "qwen2-vl-7b", "olmoe-1b-7b", "qwen2-moe-a2.7b")


@pytest.mark.parametrize("sections,dh", [((4, 2, 2), 16), ((16, 24, 24), 128)])
def test_apply_mrope_distinct_thw(sections, dh):
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 9, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
    assert not (pos[0] == pos[1]).all()
    ref = np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6, sections))
    out = layers.apply_mrope(to_torch(x), to_torch(pos), 1e6, sections)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def test_mrope_with_equal_rows_is_rope():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, 16)).astype(np.float32))
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9)
    assert torch.equal(layers.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6,
                                          (4, 2, 2)),
                       layers.apply_rope(x, pos, 1e6))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,chunk,prob", [(20, 20, 8, None),
                                              (5, 37, 16, None),
                                              (12, 12, 1024, None),
                                              (20, 20, 8, "bfloat16")])
def test_attend_chunked_matches_jax(sq, sk, chunk, prob, causal):
    rng = np.random.default_rng(sq + sk + chunk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
    qp = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (2, sq))
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (2, sk))
    ref = np.asarray(jlayers.attend_chunked(
        *(jnp.asarray(a) for a in (q, k, v, qp, kp)), causal, chunk,
        prob_dtype=prob and jnp.bfloat16))
    out = layers.attend_chunked(*(to_torch(a) for a in (q, k, v, qp, kp)),
                                causal, chunk,
                                prob_dtype=prob and torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_attend_auto_rule_picks_chunked_past_2048_keys():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 2, 16))
                                .astype(np.float32))
               for n in (3, 2049, 2049))
    qp = torch.arange(2046, 2049, dtype=torch.int32)[None]
    kp = torch.arange(2049, dtype=torch.int32)[None]
    auto = layers.attend(q, k, v, qp, kp, True)
    assert torch.equal(auto, layers.attend_chunked(q, k, v, qp, kp, True))
    assert not torch.equal(auto, layers.attend_full(q, k, v, qp, kp, True))
    with pytest.raises(ValueError, match="unknown attention impl"):
        layers.attend(q, k, v, qp, kp, True, impl="nope")


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_attend_decode_matches_jax(q_dtype):
    """bf16 cache of 24 positions, GQA group 2, rows filled to 9 and 14
    (the reference's per-row mask), and one host length for the batch."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    jq = jnp.asarray(q, q_dtype)
    jk, jv = jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)
    tq = to_torch(q).to(getattr(torch, q_dtype))
    tk, tv = to_torch(kc).bfloat16(), to_torch(vc).bfloat16()
    lens = np.array([9, 14], np.int32)
    ref = np.asarray(jlayers.attend_decode(jq, jk, jv, jnp.asarray(lens)),
                     np.float32)
    out = layers.attend_decode(tq, tk, tv, to_torch(lens))
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(to_numpy(out), ref, atol=2e-5)
    ref = np.asarray(jlayers.attend_decode(jq, jk, jv,
                                           jnp.asarray([11, 11], jnp.int32)),
                     np.float32)
    np.testing.assert_allclose(to_numpy(layers.attend_decode(tq, tk, tv, 11)),
                               ref, atol=2e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma-7b", "qwen1.5-0.5b"])
def test_embed_bitwise(arch, compute_dtype):
    jcfg = j_get_config(arch, reduced=True).replace(
        compute_dtype=compute_dtype)
    tcfg = get_config(arch, reduced=True).replace(compute_dtype=compute_dtype)
    rng = np.random.default_rng(1)
    tok = rng.standard_normal((tcfg.vocab_size, tcfg.d_model)) \
        .astype(np.float32)
    ids = rng.integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    ref = np.asarray(jlayers.embed({"tok": jnp.asarray(tok)}, jcfg,
                                   jnp.asarray(ids)), np.float32)
    out = layers.embed({"tok": to_torch(tok)}, tcfg, to_torch(ids))
    assert str(out.dtype) == f"torch.{compute_dtype}"
    np.testing.assert_array_equal(to_numpy(out), ref)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internlm2-1.8b"])
def test_unembed_tied_and_untied(arch):
    tcfg = get_config(arch, reduced=True)
    jcfg = j_get_config(arch, reduced=True)
    rng = np.random.default_rng(2)
    p = {"tok": rng.standard_normal((256, 64)).astype(np.float32)}
    if not tcfg.tie_embeddings:
        p["unembed"] = rng.standard_normal((64, 256)).astype(np.float32)
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ref = np.asarray(jlayers.unembed({k: jnp.asarray(v) for k, v in p.items()},
                                     jcfg, jnp.asarray(h)))
    out = layers.unembed({k: to_torch(v) for k, v in p.items()}, tcfg,
                         to_torch(h))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_use_kernels_flip_is_bitwise_on_cpu(arch):
    cfg = get_config(arch, reduced=True)
    params = api.init_model(cfg, 0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 11),
                           generator=torch.Generator().manual_seed(1))
    runs = []
    for uk in (False, True):
        c = cfg.replace(use_kernels=uk)
        logits, cache = make_prefill(c, 16)(params, prompt)
        outs = [logits]
        for _ in range(3):
            tok = torch.argmax(outs[-1][:, -1:], dim=-1)
            logits, cache = make_decode_step(c)(params, tok, cache)
            outs.append(logits)
        runs.append(outs + [cache["k"], cache["v"]])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
