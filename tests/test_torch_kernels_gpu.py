"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip on a host without one (a CUDA kernel has no
CPU mode). This file imports no JAX, so it runs on the GPU host as

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py

Tolerances: rectify ``out`` bitwise, its sums ``rtol=1e-5`` (reduction
order); rmsnorm 1e-5 f32 / 5e-2 bf16; flash 2e-5 f32 / 2e-2 bf16;
``ssd_chunk`` max(1e-4, 1e-5 * max|ref|): the two versions sum up to Lc*N
f32 products in different orders, and 1e-5 of the largest output is ~84 of
its ulps (the sweep of ``tests/test_kernels.py`` holds at 1e-4 itself, in
``chip_smoke.py``).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rectify.ref import (fused_step_rectify_accept_ref,
                                             fused_step_rectify_ref)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_batched_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m,p", [(32, 1024, 4), (7, 4099, 7)])
def test_rectify_kernels_bitwise(cuda, rows, m, p):
    from repro_torch.kernels.rectify import kernel
    lat = [torch.randn(rows, m, generator=cuda, device="cuda")
           for _ in range(6)]
    prev = torch.randn(p, m, generator=cuda, device="cuda")
    dt, ds = (torch.rand(rows, generator=cuda, device="cuda")
              for _ in range(2))
    fire = torch.rand(rows, generator=cuda, device="cuda") < 0.5
    assert torch.equal(kernel.fused_step_rectify(*lat, dt, ds, fire),
                       fused_step_rectify_ref(*lat, dt, ds, fire))
    out, e, o = kernel.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
    ro, re, rs = fused_step_rectify_accept_ref(*lat, prev, dt, ds, fire)
    assert torch.equal(out, ro)
    torch.testing.assert_close(e, re, rtol=1e-5, atol=0)
    torch.testing.assert_close(o, rs, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_rmsnorm_kernel(cuda, dtype, tol):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    x = torch.randn(333, 3072, generator=cuda, device="cuda").to(dtype)
    w = torch.randn(3072, generator=cuda, device="cuda").to(dtype)
    torch.testing.assert_close(rmsnorm(x, w).float(),
                               rmsnorm_ref(x, w).float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,kv", [(False, 24), (True, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel(cuda, causal, kv, dtype, tol):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q = torch.randn(2, 200, 24, 128, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(2, 200, kv, 128, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(2, 200, kv, 128, generator=cuda, device="cuda").to(dtype)
    torch.testing.assert_close(flash_attention(q, k, v, causal).float(),
                               attention_ref(q, k, v, causal).float(),
                               atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 80])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_head_dims(cuda, dh, dtype, tol):
    """The hybrid's head dims: 80 (``zamba2-2.7b``) and 16 (its reduced
    config), causal as its shared block runs, with a 77-row tail."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q, k, v = (torch.randn(2, 77, 32, dh, generator=cuda, device="cuda")
               .to(dtype) for _ in range(3))
    torch.testing.assert_close(flash_attention(q, k, v, True).float(),
                               attention_ref(q, k, v, True).float(),
                               atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("b,sq,sk,h,kv,causal", [
    (2, 128, 128, 8, 8, False),
    (2, 128, 128, 8, 8, True),    # two KV tiles: the second K/V buffer
    (2, 200, 200, 8, 2, True),    # GQA with tails
    (3, 77, 77, 4, 4, True),      # a 77-row tail
    (3, 77, 77, 4, 4, False),
    (2, 64, 333, 8, 1, False),    # MQA, cross, six KV tiles
])
def test_flash_bf16_tensor_core_route(cuda, dh, b, sq, sk, h, kv, causal):
    """The bf16 route (``flash_fwd_mma_kernel``) at every compiled head
    dim."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q = torch.randn(b, sq, h, dh, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(b, sk, kv, dh, generator=cuda, device="cuda")
            .bfloat16() for _ in range(2))
    torch.testing.assert_close(flash_attention(q, k, v, causal).float(),
                               attention_ref(q, k, v, causal).float(),
                               atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,dh,causal", [(32, 64, 24, 128, False),
                                             (32, 64, 32, 80, True)])
def test_flash_bf16_serving_shapes(cuda, b, s, h, dh, causal):
    """The DiT's attention and the hybrid's shared block as they serve."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q, k, v = (torch.randn(b, s, h, dh, generator=cuda, device="cuda")
               .bfloat16() for _ in range(3))
    torch.testing.assert_close(flash_attention(q, k, v, causal).float(),
                               attention_ref(q, k, v, causal).float(),
                               atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("g,h,lc,n,hd", [(32, 80, 64, 64, 64),  # serving
                                         (3, 4, 100, 16, 16),   # a tail
                                         (3, 3, 64, 64, 64),    # H = 3
                                         (2, 80, 256, 64, 64),  # a full chunk
                                         (4, 1, 1, 8, 8)])      # one row
def test_ssd_chunk_kernel(cuda, g, h, lc, n, hd):
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk
    c, b = (torch.randn(g, lc, n, generator=cuda, device="cuda")
            for _ in range(2))
    xdt = torch.randn(g, h, lc, hd, generator=cuda, device="cuda")
    cum = -torch.randn(g, h, lc, generator=cuda, device="cuda").abs() \
        .cumsum(-1)
    y, s = ssd_chunk(c, b, xdt, cum)
    ry, rs = ssd_chunk_batched_ref(c, b, xdt, cum)
    for out, ref in ((y, ry), (s, rs)):
        tol = max(1e-4, 1e-5 * float(ref.abs().max()))
        torch.testing.assert_close(out, ref, atol=tol, rtol=0)


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error (the
    dispatchers in ops.py pick the plain versions for CPU tensors)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    x = torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(torch.zeros(4, 8), torch.ones(8))
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk
    cb = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk(cb, cb, torch.zeros(2, 1, 8, 8), torch.zeros(2, 1, 8))
