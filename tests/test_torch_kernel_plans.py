"""The launch plans of the redesigned ``rmsnorm``, ``fused_step_rectify``
and ``fused_step_rectify_accept`` kernels, and the accept kernel's
summation order, checked on the CPU before any card is involved.

The plans are pure Python (``kernels/rmsnorm/kernel.py::plan``,
``kernels/rectify/kernel.py::step_plan`` and ``accept_plan``) and the
wrappers pass them to
the CUDA launchers as they are, so what the tests show about coverage here
holds for the launches on the card. ``accept_sums_in_kernel_order`` emulates
the accept kernel's fixed order (per-thread partials, the warp and block
shuffle trees, cluster ranks); it is held to the JAX package's Pallas
``fused_step_rectify_accept`` run in interpret mode at ``rtol=1e-5`` (the
reduction order differs from the Pallas kernel's), with inputs from a
numpy seed, as ``tests/test_torch_flash_numerics.py`` does for flash.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rectify.kernel import fused_step_rectify_accept as j_accept
from repro_torch.kernels.rectify.kernel import (MAX_CLUSTER, MAX_THREADS,
                                                TARGET_BLOCKS, AcceptPlan,
                                                StepPlan, accept_plan,
                                                step_plan)
from repro_torch.kernels.rectify.ref import (accept_sums_in_kernel_order,
                                             fused_step_rectify_accept_ref)
from repro_torch.kernels.rmsnorm.kernel import (BLOCK_THREADS, MAX_VECS,
                                                ROWS_IN_REGISTERS, TWO_SWEEPS,
                                                plan)


def _accept_coverage(m, p):
    """How many times the launch touches each column of a row: cluster
    rank b, thread t, pieces t, t + T, ... of [b*span, min(m, (b+1)*span))."""
    hits = np.zeros(m, np.int64)
    for b in range(p.cluster):
        c0, c1 = b * p.span, min(m, (b + 1) * p.span)
        for t in range(p.threads):
            starts = np.arange(c0 + t * p.vec, c1, p.threads * p.vec)
            for e in range(p.vec):
                cols = starts + e
                np.add.at(hits, cols[cols < c1], 1)
    return hits


@pytest.mark.parametrize("rows", [1, 3, 32, 64, 200])
@pytest.mark.parametrize("m", [1, 3, 1024, 4099, 100_003])
@pytest.mark.parametrize("vec_ok", [True, False])
def test_accept_plan_covers_every_column_once(rows, m, vec_ok):
    p = accept_plan(rows, m, vec_ok)
    assert 1 <= p.cluster <= MAX_CLUSTER
    assert p.cluster & (p.cluster - 1) == 0
    assert p.vec in (1, 4) and (p.vec == 1 or (vec_ok and m % 4 == 0))
    assert p.span % p.vec == 0 and p.cluster * p.span >= m
    assert 32 <= p.threads <= 256 and p.threads % 32 == 0
    assert (_accept_coverage(m, p) == 1).all()


def test_accept_plan_fills_the_card_at_the_serving_shape():
    """S*K = 32 rows of M = 1*64*16: a cluster of 4 blocks per row, 128
    blocks for the H100's 132 SMs, float4 loads."""
    p = accept_plan(32, 1024, True)
    assert p.cluster <= MAX_CLUSTER and 32 * p.cluster >= 128
    assert p == AcceptPlan(cluster=4, span=256, threads=64, vec=4)
    # a short row is not cut into blocks without a warp's worth of columns
    assert accept_plan(32, 3, True).cluster == 1
    assert accept_plan(200, 1024, True).cluster == 1


@pytest.mark.parametrize("s,want", [(1, AcceptPlan(8, 128, 32, 4)),
                                    (2, AcceptPlan(8, 128, 32, 4)),
                                    (4, AcceptPlan(4, 256, 64, 4))])
def test_accept_plan_at_every_bucket_of_the_ladder(s, want):
    """An elastic engine at the launcher defaults serves S = 1, 2, 4 slots
    of K = 8 cores: 8, 16 and 32 rows of M = 1024. Each plan covers every
    column once; the smaller grids take the largest cluster (8 blocks a
    row: 64 and 128 blocks), the full grid 4 (128)."""
    rows = s * 8
    p = accept_plan(rows, 1024, True)
    assert p == want
    assert rows * p.cluster == min(TARGET_BLOCKS, rows * MAX_CLUSTER)
    assert (_accept_coverage(1024, p) == 1).all()


def _step_coverage(m, p):
    """How many times the step launch touches each column of a row: block
    b, thread t, the ``vec`` columns from (b * threads + t) * vec, if that
    start lies in the row (as ``csrc/rectify.cu`` guards it)."""
    hits = np.zeros(m, np.int64)
    tile = p.threads * p.vec
    for b in range(-(-m // tile)):
        for t in range(p.threads):
            c = (b * p.threads + t) * p.vec
            if c < m:
                assert c + p.vec <= m  # a piece never straddles the row end
                hits[c:c + p.vec] += 1
    return hits


@pytest.mark.parametrize("rows", [1, 3, 32, 64, 65535])
@pytest.mark.parametrize("m", [1, 3, 4, 1000, 1024, 1025, 4099, 100_003])
@pytest.mark.parametrize("vec_ok", [True, False])
def test_step_plan_covers_every_column_once(rows, m, vec_ok):
    p = step_plan(rows, m, vec_ok)
    assert p.vec == (4 if vec_ok and m % 4 == 0 else 1)
    assert 32 <= p.threads <= MAX_THREADS
    assert p.threads & (p.threads - 1) == 0
    assert (_step_coverage(m, p) == 1).all()
    # the word the C launcher unpacks (csrc/rectify.cu: bits 0-11 threads,
    # bits 12-15 vec) round-trips
    assert (p.word & 4095, p.word >> 12 & 15) == tuple(p)
    assert p.word >> 16 == 0


def test_step_plan_fills_the_card_at_the_serving_shape():
    """S*K = 32 rows of M = 1*64*16: 4 tiles a row of 64 threads, one
    float4 per operand and thread, 128 blocks for the H100's 132 SMs."""
    p = step_plan(32, 1024, True)
    assert p == StepPlan(threads=64, vec=4)
    assert 32 * -(-1024 // (p.threads * p.vec)) >= TARGET_BLOCKS
    # unaligned operands: one column a thread, still >= 128 blocks
    q = step_plan(32, 1024, False)
    assert q.vec == 1 and 32 * -(-1024 // q.threads) >= TARGET_BLOCKS
    # many rows need no more tiles; a short row takes one warp
    assert step_plan(4096, 1024, True) == StepPlan(threads=256, vec=4)
    assert step_plan(32, 3, True) == StepPlan(threads=32, vec=1)


def _rmsnorm_coverage(d, p):
    hits = np.zeros(d, np.int64)
    nvec = d // p.vec
    for t in range(p.threads_per_row):
        for i in range(p.vecs_per_thread):
            j = t + i * p.threads_per_row
            if j < nvec:
                hits[j * p.vec:(j + 1) * p.vec] += 1
    return hits


@pytest.mark.parametrize("d", [1, 7, 128, 1000, 1001, 2560, 3072, 4096,
                               5120, 8192, 8200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_plan_covers_every_column_once(d, dtype, aligned):
    p = plan(d, dtype, aligned)
    full = 16 // dtype.itemsize
    assert p.vec == (full if aligned and d % full == 0 else 1)
    if p.variant == TWO_SWEEPS:
        assert d // p.vec > MAX_VECS * 256
        assert p.threads_per_row == BLOCK_THREADS and p.rows_per_block == 1
        return
    assert p.variant == ROWS_IN_REGISTERS
    assert p.threads_per_row % 32 == 0 and 1 <= p.vecs_per_thread <= MAX_VECS
    assert p.threads_per_row * p.rows_per_block <= BLOCK_THREADS
    assert (_rmsnorm_coverage(d, p) == 1).all()


def test_rmsnorm_plan_variants_by_width():
    """Which widths take which variant: every served width (3072 for the
    DiT, 2560 and the shared block's 5120 for the hybrid, bf16) keeps its
    row in registers, several rows to a block where a row needs few warps;
    f32 rows wider than 4096 and misaligned or odd rows wider than 1024
    take the two sweeps."""
    bf, f32 = torch.bfloat16, torch.float32
    assert plan(3072, bf, True) == (ROWS_IN_REGISTERS, 8, 96, 4, 2)
    assert plan(2560, bf, True) == (ROWS_IN_REGISTERS, 8, 96, 4, 2)
    assert plan(5120, bf, True) == (ROWS_IN_REGISTERS, 8, 160, 4, 1)
    assert plan(8192, bf, True).variant == ROWS_IN_REGISTERS
    assert plan(8200, bf, True).variant == TWO_SWEEPS
    assert plan(4096, f32, True).variant == ROWS_IN_REGISTERS
    assert plan(5120, f32, True) == (TWO_SWEEPS, 4, 256, 0, 1)
    assert plan(128, f32, True) == (ROWS_IN_REGISTERS, 4, 32, 1, 8)
    assert plan(1001, bf, True) == (ROWS_IN_REGISTERS, 1, 256, 4, 1)
    assert plan(1024, bf, False).variant == ROWS_IN_REGISTERS
    assert plan(3072, bf, False) == (TWO_SWEEPS, 1, 256, 0, 1)


def _accept_inputs(rows, m, p, seed):
    rng = np.random.default_rng(seed)
    lat = [rng.standard_normal((rows, m)).astype(np.float32)
           for _ in range(6)]
    prev = rng.standard_normal((p, m)).astype(np.float32)
    dt = rng.random(rows).astype(np.float32)
    ds = rng.random(rows).astype(np.float32)
    fire = rng.random(rows) < 0.5
    return lat, prev, dt, ds, fire


@pytest.mark.parametrize("m", [1, 3, 1024, 4099])
@pytest.mark.parametrize("rows,p", [(32, 4), (7, 7), (3, 1)])
@pytest.mark.parametrize("vec_ok", [True, False])
def test_accept_kernel_order_matches_jax_accept(m, rows, p, vec_ok):
    lat, prev, dt, ds, fire = _accept_inputs(rows, m, p, m * 31 + rows + p)
    prev_rows = np.repeat(prev, rows // p, axis=0)
    j_out, j_err, j_osq = (np.asarray(a) for a in j_accept(
        *(jnp.asarray(a) for a in lat), jnp.asarray(prev_rows),
        jnp.asarray(dt), jnp.asarray(ds), jnp.asarray(fire), interpret=True))
    t = [torch.from_numpy(a) for a in lat]
    out, _, _ = fused_step_rectify_accept_ref(
        *t, torch.from_numpy(prev), torch.from_numpy(dt),
        torch.from_numpy(ds), torch.from_numpy(fire))
    np.testing.assert_allclose(out.numpy(), j_out, rtol=0, atol=1e-5)
    err, osq = accept_sums_in_kernel_order(out, torch.from_numpy(prev),
                                           *accept_plan(rows, m, vec_ok))
    np.testing.assert_allclose(err.numpy(), j_err, rtol=1e-5, atol=0)
    np.testing.assert_allclose(osq.numpy(), j_osq, rtol=1e-5, atol=0)


def test_accept_kernel_order_is_not_the_plain_sum():
    """The emulation follows the kernel's tree, not ``torch.sum``: on a long
    row the two orders round differently (by far less than 1e-5)."""
    lat, prev, dt, ds, fire = _accept_inputs(32, 100_003, 4, 5)
    t = [torch.from_numpy(a) for a in lat]
    out, err, _ = fused_step_rectify_accept_ref(
        *t, torch.from_numpy(prev), torch.from_numpy(dt),
        torch.from_numpy(ds), torch.from_numpy(fire))
    k_err, _ = accept_sums_in_kernel_order(out, torch.from_numpy(prev),
                                           *accept_plan(32, 100_003, False))
    rel = ((k_err - err).abs() / err).max()
    assert 0 < rel < 1e-5


def test_rectify_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error."""
    from repro_torch.kernels.rectify.kernel import (fused_step_rectify,
                                                    fused_step_rectify_accept)
    lat = [torch.zeros(32, 1024)] * 6
    sc, fire = torch.zeros(32), torch.zeros(32, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step_rectify(*lat, sc, sc, fire)
    with pytest.raises(ValueError, match="CUDA"):
        fused_step_rectify_accept(*lat, torch.zeros(4, 1024), sc, sc, fire)


@pytest.mark.parametrize("d", [128, 1001, 2560, 3072, 5120, 8192])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_launch_config_packs_the_plan(d, aligned):
    """The one int the C launcher takes holds the dtypes and every plan
    field unclipped (bit layout of ``csrc/rmsnorm.cu``)."""
    from repro_torch.kernels.rmsnorm.kernel import launch_config
    bf, f32 = torch.bfloat16, torch.float32
    for xd, wd, codes in ((bf, bf, (1, 1)), (bf, f32, (1, 0)),
                          (f32, bf, (0, 1)), (f32, f32, (0, 0))):
        c = launch_config(d, xd, wd, aligned)
        p = plan(d, xd, aligned)
        assert (c & 1, c >> 1 & 1) == codes
        assert (c >> 2 & 3, c >> 4 & 15, c >> 12 & 4095, c >> 8 & 15,
                c >> 24 & 127) == tuple(p)


# -- flash attention: shared memory of every compiled head dim ---------------

@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk,causal", [(64, 64, False), (200, 200, True),
                                          (64, 333, False)])
def test_flash_plan_fits_a_block_at_every_head_dim(dh, dtype, sq, sk,
                                                   causal):
    """Each launch's dynamic shared memory stays within the 227 KB a block
    may use on the H100, head dim 256 included (bf16: Q and two K/V
    buffers, 165 KB; f32: 209 KB)."""
    from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                            SMEM_PER_BLOCK)
    from repro_torch.kernels.flash_attention.kernel import plan as fplan
    assert dh in HEAD_DIMS
    p = fplan(dtype, dh, 2, sq, sk, 8, causal)
    assert 0 < p.smem <= SMEM_PER_BLOCK
    assert p.grid == ((sq + 63) // 64, 8, 2)
    if dh == 256:
        want = {torch.bfloat16: 2 * 64 * 264 * (5 if sk > 64 else 3),
                torch.float32: 213760}[dtype]
        assert p.smem == want


def test_flash_plan_refuses_an_uncompiled_head_dim():
    from repro_torch.kernels.flash_attention.kernel import plan as fplan
    with pytest.raises(ValueError, match="head_dim 96"):
        fplan(torch.bfloat16, 96, 1, 64, 64, 1, False)
