"""Parity of the port's DiT denoiser and its kernels' plain versions with
the JAX package (CPU), at the reference's tolerances: the Pallas kernels
run in interpret mode as in ``tests/test_kernels.py`` (rmsnorm 1e-5 f32 /
5e-2 bf16, flash attention 2e-5 f32 / 2e-2 bf16), the denoiser through
parameters converted with ``load_jax_params`` (f32 2e-5; bf16 rtol 8e-2,
atol 5e-2). The kernels against their plain versions on the card are in
``tests/test_torch_kernels_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.diffusion import denoise as j_denoise
from repro.diffusion import init_wrapper as j_init_wrapper
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.rmsnorm.kernel import rmsnorm as j_rmsnorm
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.diffusion import denoise, init_wrapper, make_drift
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import layers
from repro_torch.utils.convert import load_jax_params, to_numpy, to_torch


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _setup(compute_dtype=None, latent=8):
    """Reference micro-DiT params loaded into the port. out_proj is drawn
    at fan-in scale (the zero init would make the drift vanish), so the
    velocity is O(1) and the absolute tolerances mean what they say."""
    jcfg = j_get_config("chords-dit-xl", reduced=True)
    tcfg = get_config("chords-dit-xl", reduced=True)
    if compute_dtype:
        jcfg = jcfg.replace(compute_dtype=compute_dtype)
        tcfg = tcfg.replace(compute_dtype=compute_dtype)
    params = j_init_wrapper(jcfg, latent, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(init_wrapper(tcfg, latent, device="cpu"),
                              _np_tree(params))
    x = np.array(jax.random.normal(jax.random.PRNGKey(4), (2, 16, latent)))
    return jcfg, params, tcfg, tparams, x


def test_load_jax_params_is_a_plain_copy():
    _, params, _, tparams, _ = _setup()
    flat = dict(tparams.named_parameters())
    assert np.array_equal(to_numpy(flat["backbone.blocks.attn.wq"]),
                          np.asarray(params["backbone"]["blocks"]["attn"]
                                     ["wq"]))
    assert flat["backbone.blocks.mlp.w_gate"].shape[0] == 4  # stacked [L]
    with pytest.raises(KeyError, match="only in JAX"):
        tree = _np_tree(params)
        tree["extra"] = np.zeros(3, np.float32)
        load_jax_params(tparams, tree)


def test_denoise_matches_jax_f32():
    jcfg, params, tcfg, tparams, x = _setup()
    for t in (0.0, 0.35, 0.9):
        ref = np.asarray(j_denoise(params, jcfg, jnp.asarray(x), t))
        out = denoise(tparams, tcfg, torch.from_numpy(x), t).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5)


def test_denoise_matches_jax_bf16():
    jcfg, params, tcfg, tparams, x = _setup("bfloat16")
    ref = np.asarray(j_denoise(params, jcfg, jnp.asarray(x), 0.35),
                     np.float32)
    out = to_numpy(denoise(tparams, tcfg, torch.from_numpy(x), 0.35))
    np.testing.assert_allclose(out, ref, rtol=8e-2, atol=5e-2)


def test_row_drift_is_per_row_denoise():
    """make_drift's per-row times equal one denoise call per row (the JAX
    package vmaps a scalar-time drift over cores instead)."""
    jcfg, params, tcfg, tparams, x = _setup()
    xs = np.stack([x, 0.5 * x, -x])  # [R=3, B=2, S, L]
    ts = np.asarray([0.1, 0.5, 0.8], np.float32)
    out = make_drift(tparams, tcfg)(torch.from_numpy(xs),
                                    torch.from_numpy(ts)).numpy()
    for r in range(3):
        ref = np.asarray(j_denoise(params, jcfg, jnp.asarray(xs[r]),
                                   float(ts[r])))
        np.testing.assert_allclose(out[r], ref, atol=2e-5)


def test_use_kernels_flip_is_bitwise_on_cpu():
    _, _, tcfg, tparams, x = _setup()
    xt = torch.from_numpy(x)
    a = denoise(tparams, tcfg, xt, 0.35)
    b = denoise(tparams, tcfg.replace(use_kernels=True), xt, 0.35)
    assert torch.equal(a, b)


@pytest.mark.parametrize("rows,d,dtype", [(64, 128, "float32"),
                                          (100, 64, "float32"),
                                          (32, 256, "bfloat16")])
def test_rmsnorm_plain_matches_pallas_interpret(rows, d, dtype):
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    ref = np.asarray(j_rmsnorm(jx, jw, block_rows=16), np.float32)
    tdt = getattr(torch, dtype)
    out = to_numpy(rmsnorm_ref(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(w).to(tdt)))
    atol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out, ref, atol=atol)
    np.testing.assert_array_equal(
        to_numpy(layers.rmsnorm(torch.from_numpy(x).to(tdt),
                                torch.from_numpy(w).to(tdt),
                                use_kernel=True)), out)


@pytest.mark.parametrize("sq,sk,h,kv,dh,causal,dtype", [
    (128, 128, 4, 4, 32, True, "float32"),
    (128, 128, 4, 2, 32, True, "float32"),    # GQA
    (64, 256, 8, 1, 64, False, "float32"),    # MQA, cross
    (64, 64, 4, 4, 32, False, "float32"),     # the denoiser's shape
    (256, 256, 2, 2, 64, True, "bfloat16"),
])
def test_flash_plain_matches_pallas_interpret(sq, sk, h, kv, dh, causal,
                                              dtype):
    rng = np.random.default_rng(sq + sk + h)
    q = rng.standard_normal((2, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, dh)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, dh)).astype(np.float32)
    ref = np.asarray(j_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                             causal=causal, bq=64, bk=64), np.float32)
    tdt = getattr(torch, dtype)
    out = to_numpy(attention_ref(*(torch.from_numpy(a).to(tdt)
                                   for a in (q, k, v)), causal))
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(out, ref, atol=atol)


def test_attend_full_matches_jax_attend_full():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    for causal in (False, True):
        ref = np.asarray(jlayers.attend_full(
            *(jnp.asarray(a) for a in (q, k, v, pos, pos)), causal))
        out = layers.attend_full(*(to_torch(a) for a in (q, k, v, pos, pos)),
                                 causal).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5)
        flipped = layers.attend(*(to_torch(a) for a in (q, k, v, pos, pos)),
                                causal, use_kernel=True).numpy()
        np.testing.assert_array_equal(flipped, out)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    ref = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        1e4))
    out = layers.apply_rope(to_torch(x), to_torch(pos), 1e4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)

