"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip on a host without one (a CUDA kernel has no
CPU mode). This file imports no JAX, so it runs on the GPU host as

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py

Tolerances: rectify ``out`` bitwise, its sums ``rtol=1e-5`` (reduction
order); rmsnorm 1e-5 f32 / 5e-2 bf16; flash 2e-5 f32 / 2e-2 bf16.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rectify.ref import (fused_step_rectify_accept_ref,
                                             fused_step_rectify_ref)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


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
