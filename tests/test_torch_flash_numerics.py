"""The bf16 flash kernel's rounding plan against the JAX package's
``flash_attention`` (Pallas, interpret mode as ``tests/test_kernels.py``
runs it), on the CPU, before any card is involved.

The tensor-core route (``csrc/flash_attention.cu``, ``flash_fwd_mma_kernel``)
rounds differently from the f32 plain version: QKᵀ and PV take bf16
operands with exact products and f32 sums, ``scale`` multiplies S in f32
(in log2 units, so the softmax is ``exp2``), the online softmax runs over
64-column KV tiles with f32 m and l, and P is rounded to bf16 before PV.
``mma_plan`` writes that plan out in plain torch; these tests hold it to
the bf16 contract of 2e-2 against the JAX kernel and the port's plain
version at ``chords-dit-micro`` widths (4 heads of 32) and at the hybrid's
head dims, so the design is known to fit the contract before a chip run.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils.convert import to_numpy

LOG2E = 1.4426950408889634
MASK = -1e30
TILE = 64


def mma_plan(q, k, v, causal: bool, scale=None):
    """The bf16 route's arithmetic on [B, S, H, Dh] bf16 tensors."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    # bf16 values are exact in f32, and so are their pairwise products
    qf = q.float()
    kf = k.float().repeat_interleave(h // kvh, dim=2)
    vf = v.float().repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * LOG2E)
    if causal:
        allowed = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(allowed, s, torch.full((), MASK))
    m = torch.full((b, h, sq), MASK)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, dh)
    for k0 in range(0, sk, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(),
                          vf[:, k0:k0 + TILE])
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal", [
    (2, 64, 64, 4, 4, 32, False),     # the micro DiT's attention, 64 tokens
    (2, 16, 16, 4, 4, 32, False),     # the parity tests' 16 tokens
    (2, 128, 128, 4, 4, 32, True),    # causal over two KV tiles
    (2, 128, 128, 4, 2, 32, True),    # GQA
    (2, 77, 77, 4, 4, 32, True),      # a tail
    (1, 64, 192, 4, 1, 32, False),    # MQA, cross, three KV tiles
    (2, 64, 64, 4, 4, 80, True),      # the hybrid's shared-block head dim
    (2, 64, 64, 4, 4, 16, True),      # its reduced config's
])
def test_mma_plan_matches_jax_flash(b, sq, sk, h, kv, dh, causal):
    rng = np.random.default_rng(sq * 7 + sk + dh + h * kv)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, dh)).astype(np.float32)
    ref = np.asarray(j_flash(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)),
                             causal=causal, bq=64 if sq % 64 == 0 else sq,
                             bk=64 if sk % 64 == 0 else sk), np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = to_numpy(mma_plan(tq, tk, tv, causal))
    np.testing.assert_allclose(out, ref, atol=2e-2)
    plain = to_numpy(attention_ref(tq, tk, tv, causal))
    np.testing.assert_allclose(out, plain, atol=2e-2)


def test_mma_plan_rounds_p_and_keeps_the_scale_in_f32():
    """The plan is not the plain version in disguise: rounding P to bf16
    moves the output (by far less than the contract), and applying the
    scale to S in f32 gives the same S as scaling q first up to f32
    rounding, never a bf16-rounded q."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 4, 32))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    diff = (mma_plan(q, k, v, False).float()
            - attention_ref(q, k, v, False).float()).abs().max()
    assert 0 < diff < 2e-2
    scale = 1.0 / math.sqrt(32)
    s_plan = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s_pre = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    s_bf16q = torch.einsum("bqhd,bkhd->bhqk", (q.float() * scale)
                           .bfloat16().float(), k.float())
    assert (s_plan - s_pre).abs().max() < 1e-5
    assert (s_bf16q - s_pre).abs().max() > 1e-4
