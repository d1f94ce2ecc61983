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
from repro_torch.kernels.rectify.ref import (accept_sums_in_kernel_order,
                                             fused_step_rectify_accept_ref,
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


# (rows, M, offset): the serving shape, M = 1, odd M, M % 4 == 0 but the
# operands a view 4 bytes (offset 1) off 16-byte alignment, a long row,
# and the 65535-row limit
STEP_CASES = [(32, 1024, 0), (32, 1, 0), (7, 4099, 0), (32, 1024, 1),
              (64, 100_003, 0), (65535, 3, 0), (65535, 8, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m,offset", STEP_CASES)
def test_step_rectify_kernel_sweep(cuda, rows, m, offset):
    """The step kernel bitwise its plain version through both load widths
    (``step_plan``: float4 where aligned, one column a thread where not),
    and one device kernel a call (no cast of ``fire``): in a profiler
    window, with host gaps at its edges as ``chip_smoke.profiled`` keeps
    them, and in a CUDA graph captured from one call."""
    import time
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import GAP_S, graph_kernel_nodes
    from repro_torch.kernels.rectify import kernel
    flat = [torch.randn(rows * m + offset, generator=cuda, device="cuda")
            for _ in range(6)]
    lat = [t[offset:].view(rows, m) for t in flat]
    dt, ds = (torch.rand(rows, generator=cuda, device="cuda")
              for _ in range(2))
    fire = torch.rand(rows, generator=cuda, device="cuda") < 0.5
    out = kernel.fused_step_rectify(*lat, dt, ds, fire)
    assert torch.equal(out, fused_step_rectify_ref(*lat, dt, ds, fire))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(GAP_S)
        for _ in range(4):
            kernel.fused_step_rectify(*lat, dt, ds, fire)
        torch.cuda.synchronize()
        time.sleep(GAP_S)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "step_rectify_kernel" in kernels[0].key
    assert kernels[0].count == 4
    assert graph_kernel_nodes(
        lambda: kernel.fused_step_rectify(*lat, dt, ds, fire)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_rmsnorm_kernel(cuda, dtype, tol):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    x = torch.randn(333, 3072, generator=cuda, device="cuda").to(dtype)
    w = torch.randn(3072, generator=cuda, device="cuda").to(dtype)
    torch.testing.assert_close(rmsnorm(x, w).float(),
                               rmsnorm_ref(x, w).float(), atol=tol, rtol=0)


# (rows, M, P) with P dividing rows: P = 1, 4 (where it divides) and rows
ACCEPT_CASES = sorted({(rows, m, p) for rows in (1, 3, 32, 64)
                       for m in (1, 3, 1024, 1_000_003)
                       for p in (1, 4, rows) if rows % p == 0})


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m,p", ACCEPT_CASES)
def test_accept_kernel_sweep(cuda, rows, m, p):
    """The one-launch accept kernel: ``out`` bitwise its plain version, the
    sums within rtol 1e-5 of it, bitwise equal between two launches and
    bitwise the kernel's order emulated in plain torch."""
    from repro_torch.kernels.rectify import kernel
    lat = [torch.randn(rows, m, generator=cuda, device="cuda")
           for _ in range(6)]
    prev = torch.randn(p, m, generator=cuda, device="cuda")
    dt, ds = (torch.rand(rows, generator=cuda, device="cuda")
              for _ in range(2))
    fire = torch.rand(rows, generator=cuda, device="cuda") < 0.5
    out, e, o = kernel.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
    _, e2, o2 = kernel.fused_step_rectify_accept(*lat, prev, dt, ds, fire)
    ro, re, rs = fused_step_rectify_accept_ref(*lat, prev, dt, ds, fire)
    assert torch.equal(out, ro)
    torch.testing.assert_close(e, re, rtol=1e-5, atol=0)
    torch.testing.assert_close(o, rs, rtol=1e-5, atol=0)
    assert torch.equal(e, e2) and torch.equal(o, o2)
    ke, ko = accept_sums_in_kernel_order(
        ro, prev, *kernel.accept_plan(rows, m, True))
    assert torch.equal(e, ke) and torch.equal(o, ko)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [128, 1000, 2560, 3072, 5120])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-2)])
def test_rmsnorm_kernel_widths(cuda, d, dtype, tol, offset):
    """Both variants (5120 f32 takes the two sweeps, every other width the
    rows in registers), 16-byte vectors and, for a view one element off
    16-byte alignment (offset 1), one element at a time."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    rows = 300
    flat = torch.randn(rows * d + offset, generator=cuda, device="cuda")
    x = flat.to(dtype)[offset:].view(rows, d)
    w = torch.randn(d, generator=cuda, device="cuda").to(dtype)
    torch.testing.assert_close(rmsnorm(x, w).float(),
                               rmsnorm_ref(x, w).float(), atol=tol, rtol=0)


@pytest.mark.gpu
def test_rmsnorm_kernel_follows_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` the kernel runs on s: with the default
    stream held busy by a long sleep, the result is complete once s alone
    has finished, and the default stream is still busy then."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    x = torch.randn(2048, 3072, generator=cuda, device="cuda").bfloat16()
    w = torch.randn(3072, generator=cuda, device="cuda").bfloat16()
    ref = rmsnorm_ref(x, w)
    rmsnorm(x, w)  # build, load and plan before the clock starts
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    torch.cuda._sleep(2_000_000_000)  # ~1 s of the default stream
    with torch.cuda.stream(s):
        out = rmsnorm(x, w)
    s.synchronize()
    busy = not torch.cuda.current_stream().query()
    with torch.cuda.stream(s):
        err = float((out.float() - ref.float()).abs().max())
    s.synchronize()
    torch.cuda.synchronize()
    assert busy, "the default stream finished first: the test proves nothing"
    assert err <= 5e-2


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
