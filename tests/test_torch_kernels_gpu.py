"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip on a host without one (a CUDA kernel has no
CPU mode). This file imports no JAX, so it runs on the GPU host as

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_gpu.py

Tolerances: rectify ``out`` bitwise, its sums ``rtol=1e-5`` (reduction
order); rmsnorm 1e-5 f32 / 5e-2 bf16; flash 2e-5 f32 / 2e-2 bf16;
``ssd_chunk`` max(1e-4, 1e-5 * max|ref|): the two versions sum up to Lc*N
f32 products in different orders, and 1e-5 of the largest output is ~84 of
its ulps (the sweep of ``tests/test_kernels.py`` holds at 1e-4 itself, in
``chip_smoke.py``); the device loop's condition kernel exactly. The grid's
CUDA graphs (``serve/graphs.py``) are held to the eager programs bitwise at
a micro DiT: the same kernels run on the same data.
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
    window, opened by the primer and with host gaps at its edges as
    ``chip_smoke.profiled`` keeps them, and in a CUDA graph captured from
    one call."""
    import time
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import GAP_S, PRIME_TAG, _prime, graph_kernel_nodes
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
        _prime()
        time.sleep(GAP_S)
        for _ in range(4):
            kernel.fused_step_rectify(*lat, dt, ds, fire)
        torch.cuda.synchronize()
        time.sleep(GAP_S)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and PRIME_TAG not in e.key]
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
@pytest.mark.parametrize("dh", [16, 80, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_head_dims(cuda, dh, dtype, tol):
    """The hybrid's head dims: 80 (``zamba2-2.7b``) and 16 (its reduced
    config), and 256 (``gemma-7b``), causal with a 77-row tail, on both
    routes."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 4, 64])
def test_device_loop_kernel_matches_ref(cuda, s):
    """The condition kernel against ``ref.loop_step_ref`` on random flags:
    entry, then steps with done rising and live falling, multi and roll."""
    from repro_torch.kernels.device_loop.kernel import loop_step
    from repro_torch.kernels.device_loop.ref import (EXIT_ON_ACCEPT, FIRST,
                                                     loop_step_ref)
    for flags in (EXIT_ON_ACCEPT, 0):
        done = torch.rand(s, generator=cuda, device="cuda") < 0.3
        live = torch.rand(s, generator=cuda, device="cuda") < 0.5
        d0k, d0r = (torch.zeros(s, dtype=torch.bool, device="cuda")
                    for _ in range(2))
        ck, cr = (torch.tensor([5, 7, 9, 0], dtype=torch.int32,
                               device="cuda") for _ in range(2))
        for i in range(8):
            f = flags | (FIRST if i == 0 else 0)
            gk = loop_step(live, done, d0k, ck, f)
            gr = loop_step_ref(live, done, d0r, cr, f)
            assert torch.equal(ck, cr) and torch.equal(d0k, d0r), (s, i, f)
            assert int(gk) == int(gr)
            live = live & (torch.rand(s, generator=cuda, device="cuda")
                           < 0.8)
            done = done | (torch.rand(s, generator=cuda, device="cuda")
                           < 0.1)


def _micro_grid(eager, num_slots=3, rtol=0.3, device_rounds=None):
    """A micro ``chords-dit-xl`` (the port's kernels on) on a grid with
    every slot admitted, noise from a seeded generator: the same data
    on the graphs and on the eager programs."""
    from repro_torch.configs import get_config
    from repro_torch.core.init_sequence import make_sequence
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import init_wrapper, make_drift
    from repro_torch.serve.executor import GridSpec, RoundExecutor
    n, k, latent = 12, 4, (1, 16, 8)
    cfg = get_config("chords-dit-xl", reduced=True).replace(use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_wrapper(cfg, 8, generator=gen, device="cuda")
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.05, generator=gen)
    ex = RoundExecutor(make_drift(params, cfg), uniform_tgrid(n,
                                                              device="cuda"),
                       n, use_kernel=True, eager=eager)
    progs = ex.grid(GridSpec(num_slots, k, latent,
                             device_rounds=device_rounds))
    x0 = torch.randn((num_slots,) + latent, generator=gen, device="cuda")
    i_arr = torch.tensor([make_sequence(k, n)] * num_slots,
                         dtype=torch.int32, device="cuda")
    rtol_t = torch.linspace(0.0, rtol, num_slots, device="cuda")
    with torch.no_grad():
        st = progs.admit(progs.init_state(),
                         torch.ones(num_slots, dtype=torch.bool,
                                    device="cuda"), x0, i_arr, rtol_t)
    return ex, progs, st


def _snapshot(st):
    from repro_torch.serve.executor import state_tensors
    return [t.clone() for t in state_tensors(st)]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_graph_programs_bitwise_eager(cuda):
    """round, roll(5) and multi(64) as CUDA graph launches against the
    eager programs on the same data: every state tensor bitwise, the same
    rounds run; the graph's state is advanced in place."""
    runs = {}
    with torch.no_grad():
        for graphs in (False, True):
            ex, progs, st = _micro_grid(not graphs)
            assert ex.programs == ("graph" if graphs else "eager")
            seq = [_snapshot(st)]
            st = progs.round(st)
            seq.append(_snapshot(st))
            st = progs.roll(st, 5)
            seq.append(_snapshot(st))
            st, ran = progs.multi(st, 64)
            seq.append(_snapshot(st) + [ran.clone()])
            torch.cuda.synchronize()
            runs[graphs] = seq
    for i, (a, b) in enumerate(zip(runs[False], runs[True])):
        assert _same(a, b), i
    assert int(runs[True][-1][-1]) >= 1


@pytest.mark.gpu
def test_graph_multi_exits_at_first_new_accept(cuda):
    """The graph loop stops at the round the first lane accepts (walked
    round by round with the eager programs). The kernels' own device
    counts show the replayed rounds ran the eager rounds' kernels, plus the
    condition kernel once at entry and once a round, and the loop's device
    clock advanced; the static cap holds."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.device_loop.kernel import clock
    with torch.no_grad():
        _, eager, st = _micro_grid(True)
        reset_launch_counts()
        first = None
        for r in range(1, 13):
            st = eager.round(st)
            if bool(st.done.any()):
                first = r
                break
        walked = launch_counts()
        _, progs, st = _micro_grid(False)
        reset_launch_counts()
        ns0 = clock()[1]
        st, ran = progs.multi(st, 64)
        assert int(ran) == first
        counts = launch_counts()
        assert clock()[1] > ns0
        assert counts["fused_step_rectify_accept"] == first
        assert counts.pop("device_loop") == 1 + first
        assert walked.pop("device_loop") == 0
        assert counts == walked and counts["rmsnorm"] > 0
        _, capped, st = _micro_grid(False, rtol=0.0, device_rounds=2)
        _, ran = capped.multi(st, 64)
        assert int(ran) == 2


@pytest.mark.gpu
def test_graph_roll_replays_the_round(cuda):
    """roll(k) on the graphs is k launches of the round graph: the kernels
    count k rounds of the eager round's launches, and no condition
    kernel."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    with torch.no_grad():
        _, eager, st = _micro_grid(True, rtol=0.0)
        reset_launch_counts()
        eager.round(st)
        one = launch_counts()
        _, progs, st = _micro_grid(False, rtol=0.0)
        reset_launch_counts()
        progs.roll(st, 3)
        counts = launch_counts()
    assert counts == {name: 3 * c for name, c in one.items()}
    assert counts["fused_step_rectify_accept"] == 3
    assert counts["device_loop"] == 0


@pytest.mark.gpu
def test_graph_grid_evicted_frees_and_refuses(cuda):
    """A grid evicted from the executor's cache frees its graphs: its
    programs refuse further calls; a grid's state buffers serve one
    engine."""
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.serve.executor import GridSpec, RoundExecutor
    ex = RoundExecutor(lambda x, t: -x, uniform_tgrid(8, device="cuda"), 8,
                       max_entries=1)
    first = ex.grid(GridSpec(2, 2, (4,)))
    st = first.init_state()
    with pytest.raises(RuntimeError, match="own"):
        first.init_state()
    first.round(st)
    ex.grid(GridSpec(3, 2, (4,)))
    assert ex.retraces == 2
    with pytest.raises(RuntimeError, match="evicted"):
        first.round(st)


@pytest.mark.gpu
def test_graph_capture_error_raises(cuda):
    """A round that synchronizes cannot be captured: building the grid
    raises; nothing falls back to eager rounds."""
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.serve.executor import GridSpec, RoundExecutor

    def syncing_drift(x, t):
        return -x * float(t.sum())  # a device->host read inside the round

    ex = RoundExecutor(syncing_drift, uniform_tgrid(8, device="cuda"), 8)
    with pytest.raises(RuntimeError):
        ex.grid(GridSpec(2, 2, (4,)))
    assert ex.programs == "graph"


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
def test_graph_engine_bitwise_eager(cuda, overlap):
    """The engine at R=8 on the graph programs against R=1 on the eager
    ones: the same samples bitwise, rounds, core and speculation counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import init_wrapper, make_drift
    from repro_torch.serve import ContinuousEngine, Request
    from repro_torch.serve.executor import RoundExecutor
    n = 12
    cfg = get_config("chords-dit-xl", reduced=True).replace(use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_wrapper(cfg, 8, generator=gen, device="cuda")
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.05, generator=gen)
    drift, tgrid = make_drift(params, cfg), uniform_tgrid(n, device="cuda")
    out, stats = {}, {}
    for graphs, r_dev in ((False, 1), (True, 8)):
        ex = RoundExecutor(drift, tgrid, n, use_kernel=True,
                           eager=not graphs)
        eng = ContinuousEngine(drift, (1, 16, 8), n, 4, tgrid, num_slots=2,
                               rtol=0.2, overlap=overlap, executor=ex,
                               guard_syncs=overlap, device="cuda")
        for i in range(5):
            eng.submit(Request(rid=i, seed=40 + i))
        with torch.no_grad():
            out[graphs] = dict(eng.run_until_drained(
                max_rounds_on_device=r_dev))
        stats[graphs] = eng.stats()
    for rid, a in out[False].items():
        b = out[True][rid]
        assert torch.equal(a.sample, b.sample), rid
        assert (a.rounds_used, a.accepted_core, a.latency_rounds) == \
            (b.rounds_used, b.accepted_core, b.latency_rounds)
    for key in ("rounds_total", "served", "speculations",
                "speculation_rollbacks"):
        assert stats[False][key] == stats[True][key], key
    assert stats[True]["programs"] == "graph"
    assert stats[True]["host_syncs"] < stats[False]["host_syncs"] or overlap


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {"min_slots": 1, "max_slots": 4, "resize_hysteresis": 2},
    {"min_slots": 1, "max_slots": 4, "resize_hysteresis": 2,
     "overlap": True},
    {"lane_profile": "default", "mode": "adaptive"},
    {"lane_profile": "default", "mode": "draft", "overlap": True}],
    ids=["elastic-sync", "elastic-overlap", "lanes-adaptive",
         "lanes-draft-overlap"])
def test_graph_elastic_and_lane_engines_bitwise_eager(cuda, kw):
    """Elastic resizes (migration into a graph grid's buffers, a bucket's
    re-entry) and lane grids on the graph programs against the eager ones:
    the same schedule, so the same shapes every round, and samples, rounds,
    cores, resizes and skips equal bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.diffusion import init_wrapper, make_drift
    from repro_torch.serve import ContinuousEngine, Request
    from repro_torch.serve.executor import RoundExecutor
    kw = dict(kw)
    mode = kw.pop("mode", "exact")
    n = 12
    cfg = get_config("chords-dit-xl", reduced=True).replace(use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = init_wrapper(cfg, 8, generator=gen, device="cuda")
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.05, generator=gen)
    drift, tgrid = make_drift(params, cfg), uniform_tgrid(n, device="cuda")
    out, stats = {}, {}
    for graphs in (False, True):
        ex = RoundExecutor(drift, tgrid, n, use_kernel=True,
                           eager=not graphs)
        eng = ContinuousEngine(drift, (1, 16, 8), n, 4, tgrid, num_slots=2,
                               rtol=0.2, executor=ex, device="cuda", **kw)
        with torch.no_grad():
            done = []
            for i in range(6):
                eng.submit(Request(rid=i, seed=60 + i, mode=mode))
                if i == 0:
                    done += eng.step()  # rid 0 in flight when the grid grows
            done += eng.run_until_drained()
        out[graphs], stats[graphs] = dict(done), eng.stats()
    for rid, a in out[False].items():
        b = out[True][rid]
        assert torch.equal(a.sample, b.sample), rid
        assert (a.rounds_used, a.accepted_core) == (b.rounds_used,
                                                    b.accepted_core)
    for key in ("rounds_total", "resizes", "migrations", "lane_skips",
                "buckets_visited"):
        assert stats[False][key] == stats[True][key], key
    assert stats[True]["programs"] == "graph"
    assert stats[True]["migrations"] > 0 or stats[True]["lane_skips"] > 0


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
    from repro_torch.kernels.device_loop.kernel import loop_step
    flags = torch.zeros(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        loop_step(flags, flags, flags, torch.zeros(4, dtype=torch.int32), 2)


# -- the stream program as one graph, and the drift's row independence ------

def _micro_dit(seed=2, latent=8):
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper, make_drift
    cfg = get_config("chords-dit-xl", reduced=True).replace(use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_wrapper(cfg, latent, generator=gen, device="cuda")
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.05, generator=gen)
    return make_drift(params, cfg)


@pytest.mark.gpu
@pytest.mark.parametrize("rtol", [0.0, 0.2])
def test_stream_graph_bitwise_eager(cuda, rtol):
    """``ChordsEngine`` on the stream graph against the eager stream
    program: samples bitwise, rounds and cores equal, one readback a batch
    on the graph (one a round more on the eager loop), and the step
    kernel's device-counted launches equal the rounds the loop ran."""
    from repro_torch import kernels
    from repro_torch.core.ode import uniform_tgrid
    from repro_torch.serve import ChordsEngine, Request
    from repro_torch.serve.executor import RoundExecutor
    n = 12
    drift, tgrid = _micro_dit(), uniform_tgrid(n, device="cuda")
    out, engs = {}, {}
    for graphs in (False, True):
        ex = RoundExecutor(drift, tgrid, n, use_kernel=True,
                           eager=not graphs)
        eng = ChordsEngine(drift, (16, 8), n, 4, tgrid, max_batch=4,
                           rtol=rtol, executor=ex, device="cuda")
        for i in range(8):
            eng.submit(Request(rid=i, seed=60 + i))
        with torch.no_grad():
            done = eng.step()  # the first batch builds the graph
            kernels.reset_launch_counts()
            before = eng.sampler.program.rounds_run
            while eng.queue:
                done += eng.step()
        counts = kernels.launch_counts()
        out[graphs], engs[graphs] = dict(done), eng
        assert counts["fused_step_rectify"] == \
            eng.sampler.program.rounds_run - before > 0
    for rid, a in out[False].items():
        b = out[True][rid]
        assert torch.equal(a.sample, b.sample), rid
        assert (a.rounds_used, a.accepted_core) == (b.rounds_used,
                                                    b.accepted_core)
    g, e = engs[True].sampler, engs[False].sampler
    assert g.host_readbacks == len(engs[True].stats) == 2  # 8 requests / 4
    assert e.host_readbacks > g.host_readbacks
    assert g.program.rounds_run == e.program.rounds_run
    assert type(g.program).__name__ == "GraphStream"


@pytest.mark.gpu
def test_drift_rows_do_not_depend_on_the_grid(cuda):
    """The served drift (``chords-dit-xl`` widths, bf16, cut to 2 layers)
    of one slot's rows (K=8 cores x 64 tokens) is bitwise the same alone
    and inside grids of 2 and 4 slots: the f32 out-projection runs in fixed
    pieces, and the backbone's products, rmsnorm and flash were already
    row independent at these shapes."""
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper, make_drift
    cfg = get_config("chords-dit-xl").replace(use_kernels=True, num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_wrapper(cfg, 16, generator=gen, device="cuda")
    with torch.no_grad():
        params["out_proj"].normal_(0.0, 0.02, generator=gen)
    drift = make_drift(params, cfg)
    x = torch.randn(4 * 8, 1, 64, 16, generator=gen, device="cuda")
    t = torch.rand(4 * 8, generator=gen, device="cuda")
    with torch.no_grad():
        alone = drift(x[:8], t[:8])
        for s in (2, 4):
            assert torch.equal(drift(x[:8 * s], t[:8 * s])[:8], alone), s


# -- LM serving: prefill and KV-cache decode with the kernels ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "internlm2-1.8b",
                                  "gemma-7b"])
def test_lm_prefill_and_decode_kernels_vs_plain(cuda, arch):
    """The three flash LM prefill shapes (causal; GQA group 7, group 2, Dh
    256) through the served path: the published attention widths, 2
    layers, a cut FFN and vocabulary, bf16, batch 4 of 512 tokens. Prefill
    and 4 decode steps (teacher-forced) with the kernels against the plain
    path, the norm weights drawn off 1: last-position logits within
    relative L2 2e-2 (the bf16 bound of the smoke); launches exact (2 rmsnorm and 1 flash a layer a prefill,
    none with the plain path)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import make_decode_step, make_prefill
    cfg = get_config(arch).replace(num_layers=2, d_ff=1024, vocab_size=4096)
    params = api.init_model(cfg, cuda, device="cuda")
    for name, w in params.named_parameters():   # norms drawn off 1
        if name.endswith(("ln1", "ln2", "final_norm")):
            w.copy_(1.0 + 0.1 * torch.randn(w.shape, generator=cuda,
                                            device="cuda"))
    prompt = torch.randint(0, cfg.vocab_size, (4, 512), generator=cuda,
                           device="cuda")
    runs = {}
    for uk in (True, False):
        c = cfg.replace(use_kernels=uk)
        kernels.reset_launch_counts()
        with torch.no_grad():
            logits, cache = make_prefill(c, 520)(params, prompt)
            counts = kernels.launch_counts()
            last = [logits[:, -1].float()]
            toks = runs[True]["toks"] if not uk else \
                torch.randint(0, cfg.vocab_size, (4, 4), generator=cuda,
                              device="cuda")
            for i in range(4):
                logits, cache = make_decode_step(c)(params, toks[:, i:i + 1],
                                                    cache)
                last.append(logits[:, -1].float())
        runs[uk] = {"last": last, "toks": toks, "counts": counts}
    assert runs[True]["counts"]["rmsnorm"] == 4
    assert runs[True]["counts"]["flash_attention"] == 2
    assert runs[False]["counts"]["flash_attention"] == 0
    for a, b in zip(runs[True]["last"], runs[False]["last"]):
        assert float((a - b).norm() / b.norm()) <= 2e-2


@pytest.mark.gpu
def test_moe_combine_bitwise_on_a_rerun(cuda):
    """The MoE layer at olmoe's published widths (64 experts, top-8), bf16,
    2048 tokens: bitwise the same on reruns on the card. Its combine adds a
    token's k outputs in one fixed order, where a bf16 ``index_add_`` is
    atomic and its sums change between runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.utils.pspec import init_params
    cfg = get_config("olmoe-1b-7b")
    p = init_params(moe.moe_specs(cfg), cuda, torch.bfloat16, device="cuda")
    x = torch.randn(4, 512, cfg.d_model, generator=cuda,
                    device="cuda").bfloat16()
    with torch.no_grad():
        first = moe.moe_ffn(p, cfg, x)
        for _ in range(4):
            assert torch.equal(moe.moe_ffn(p, cfg, x), first)
