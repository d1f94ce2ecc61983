"""Parity of the port's CHORDS core with the JAX package (CPU): scheduler
index math, init sequences and the time grid exactly; the rectify update
bitwise against the JAX oracle and within 1e-5 of the Pallas kernel run in
interpret mode; Algorithm 1 on a Gaussian-mixture drift within 1e-5 with
exact emit rounds and streaming accept."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chords as jchords
from repro.core import init_sequence as jinit
from repro.core import ode as jode
from repro.core import scheduler as jsched
from repro.kernels.rectify.kernel import (fused_step_rectify as
                                          j_rectify_kernel,
                                          fused_step_rectify_accept as
                                          j_accept_kernel)
from repro.kernels.rectify.ref import (fused_step_rectify_accept_ref as
                                       j_accept_ref,
                                       fused_step_rectify_ref as j_rectify_ref)
from repro_torch.core import chords as tchords
from repro_torch.core import init_sequence as tinit
from repro_torch.core import ode as tode
from repro_torch.core import scheduler as tsched
from repro_torch.core.solvers import sequential_sample
from repro_torch.kernels.rectify import ops as rectify_ops
from repro_torch.kernels.rectify.ref import (fused_step_rectify_accept_ref,
                                             fused_step_rectify_ref)

SEQS = [[0, 2, 4, 8, 16, 24, 32, 40], [0, 8, 16, 32], [0, 3, 6, 12, 24, 36],
        [0, 1], [0]]


@pytest.mark.parametrize("i_seq", SEQS, ids=str)
def test_scheduler_matches_exactly(i_seq):
    n = 50
    i_j = jnp.asarray(i_seq, jnp.int32)
    i_t = torch.as_tensor(i_seq, dtype=torch.int32)
    for r in range(1, n + len(i_seq) + 2):
        cj, nj = jsched.positions(i_j, r)
        ct, nt = tsched.positions(i_t, r)
        np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
        np.testing.assert_array_equal(np.asarray(nj), nt.numpy())
        cn, nn_ = tsched.positions_np(i_seq, r)
        np.testing.assert_array_equal(cn, ct.numpy())
        np.testing.assert_array_equal(nn_, nt.numpy())
    np.testing.assert_array_equal(jsched.emit_rounds(i_seq, n),
                                  tsched.emit_rounds(i_seq, n))
    np.testing.assert_array_equal(
        np.asarray(jsched.emit_rounds_jnp(i_j, n)),
        tsched.emit_rounds_t(i_t, n).numpy())


def test_slot_positions_match_per_slot_calls():
    """The port's batched positions ([S, K] with per-slot rounds) equal the
    reference's per-slot calls."""
    i_arr = np.asarray([[0, 2, 4, 8], [0, 8, 16, 32], [0, 1, 2, 3]])
    r = np.asarray([1, 7, 30])
    ct, nt = tsched.positions(torch.as_tensor(i_arr, dtype=torch.int32),
                              torch.as_tensor(r))
    for s in range(3):
        cj, nj = jsched.positions(jnp.asarray(i_arr[s], jnp.int32), int(r[s]))
        np.testing.assert_array_equal(np.asarray(cj), ct[s].numpy())
        np.testing.assert_array_equal(np.asarray(nj), nt[s].numpy())


@pytest.mark.parametrize("k,n", [(4, 50), (6, 50), (8, 50), (8, 12),
                                 (3, 10), (5, 37), (2, 20)])
def test_make_sequence_matches(k, n):
    for mode in ("auto", "theorem", "uniform"):
        assert tinit.make_sequence(k, n, mode) == jinit.make_sequence(k, n,
                                                                      mode)


def test_paper_speedups():
    """50/21, 50/19 and 50/17 at K = 4, 6, 8 (as the reference's
    test_speedups_match_paper_formula), through the port's chords_sample."""
    n = 50
    tg = tode.uniform_tgrid(n)
    for k, expect in [(4, 50 / 21), (6, 50 / 19), (8, 50 / 17)]:
        res = tchords.chords_sample(tode.exponential_drift, torch.ones(2),
                                    tg, tinit.make_sequence(k, n),
                                    device="cpu")
        assert res.speedup(k - 1) == pytest.approx(expect)


@pytest.mark.parametrize("n", [1, 7, 12, 17, 50, 100, 1000])
@pytest.mark.parametrize("t_max", [1.0, 0.98, 0.999])
def test_uniform_tgrid_bitwise(n, t_max):
    np.testing.assert_array_equal(np.asarray(jode.uniform_tgrid(n, t_max)),
                                  tode.uniform_tgrid(n, t_max).numpy())


def _rectify_inputs(k, m, seed):
    rng = np.random.default_rng(seed)
    lat = [rng.standard_normal((k, m)).astype(np.float32) for _ in range(7)]
    dt = rng.uniform(size=k).astype(np.float32)
    ds = rng.uniform(size=k).astype(np.float32)
    fire = rng.uniform(size=k) < 0.5
    return lat, dt, ds, fire


@pytest.mark.parametrize("k,m,seed", [(1, 5, 0), (4, 300, 1), (8, 1024, 2),
                                      (3, 4099, 3)])
def test_rectify_plain_is_bitwise_the_jax_oracle(k, m, seed):
    lat, dt, ds, fire = _rectify_inputs(k, m, seed)
    tj = [jnp.asarray(a) for a in lat]
    tt = [torch.from_numpy(a) for a in lat]
    sj = (jnp.asarray(dt), jnp.asarray(ds), jnp.asarray(fire))
    st = (torch.from_numpy(dt), torch.from_numpy(ds), torch.from_numpy(fire))
    out_j = np.asarray(j_rectify_ref(*tj[:6], *sj))
    out_t = fused_step_rectify_ref(*tt[:6], *st).numpy()
    np.testing.assert_array_equal(out_j, out_t)
    oj, ej, sj_ = (np.asarray(a) for a in j_accept_ref(*tj, *sj))
    ot, et, st_ = (a.numpy() for a in fused_step_rectify_accept_ref(*tt, *st))
    np.testing.assert_array_equal(oj, ot)
    # the sums reduce in each framework's own order
    np.testing.assert_allclose(et, ej, rtol=1e-5)
    np.testing.assert_allclose(st_, sj_, rtol=1e-5)


@pytest.mark.parametrize("k,m,seed", [(2, 300, 4), (5, 129, 5)])
def test_rectify_plain_matches_pallas_interpret_kernel(k, m, seed):
    lat, dt, ds, fire = _rectify_inputs(k, m, seed)
    tj = [jnp.asarray(a) for a in lat]
    sj = (jnp.asarray(dt), jnp.asarray(ds), jnp.asarray(fire))
    tt = [torch.from_numpy(a) for a in lat]
    st = (torch.from_numpy(dt), torch.from_numpy(ds), torch.from_numpy(fire))
    out_k = np.asarray(j_rectify_kernel(*tj[:6], *sj, block_m=128,
                                        interpret=True))
    np.testing.assert_allclose(fused_step_rectify_ref(*tt[:6], *st).numpy(),
                               out_k, atol=1e-5)
    ok_, ek, sk = (np.asarray(a) for a in j_accept_kernel(
        *tj, *sj, block_m=128, interpret=True))
    ot, et, st_ = (a.numpy() for a in fused_step_rectify_accept_ref(*tt, *st))
    np.testing.assert_allclose(ot, ok_, atol=1e-5)
    np.testing.assert_allclose(et, ek, rtol=1e-5)
    np.testing.assert_allclose(st_, sk, rtol=1e-5)


def test_rectify_accept_grouped_prev_equals_broadcast():
    """prev [S, M] shared by each slot's K cores == the reference's
    broadcast [S*K, M] prev."""
    lat, dt, ds, fire = _rectify_inputs(8, 64, 6)
    tt = [torch.from_numpy(a) for a in lat]
    st = (torch.from_numpy(dt), torch.from_numpy(ds), torch.from_numpy(fire))
    prev = tt[6][:2]
    grouped = fused_step_rectify_accept_ref(*tt[:6], prev, *st)
    full = fused_step_rectify_accept_ref(*tt[:6],
                                         prev.repeat_interleave(4, 0), *st)
    for a, b in zip(grouped, full):
        assert torch.equal(a, b)


def test_use_kernel_flip_is_bitwise_on_cpu():
    lat, dt, ds, fire = _rectify_inputs(6, 200, 7)
    tt = [torch.from_numpy(a) for a in lat]
    st = (torch.from_numpy(dt), torch.from_numpy(ds), torch.from_numpy(fire))
    a = rectify_ops.step_rectify(*tt[:6], *st, use_kernel=True)
    b = rectify_ops.step_rectify(*tt[:6], *st, use_kernel=False)
    assert torch.equal(a, b)
    a = rectify_ops.step_rectify_accept(*tt, *st, use_kernel=True)
    b = rectify_ops.step_rectify_accept(*tt, *st, use_kernel=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _gmm_pair(seed=0, modes=6, dim=16):
    gm = jode.GaussianMixture.random(jax.random.PRNGKey(seed),
                                     num_modes=modes, dim=dim)
    gt = tode.GaussianMixture(torch.from_numpy(np.array(gm.mus)),
                              torch.from_numpy(np.array(gm.sigmas)),
                              torch.from_numpy(np.array(gm.weights)))
    return gm, gt


def test_gaussian_mixture_drift_matches():
    gm, gt = _gmm_pair()
    x = np.random.default_rng(0).standard_normal((3, 4, 16)).astype(
        np.float32)
    t = np.asarray([0.1, 0.5, 0.9], np.float32)
    ref = np.stack([np.asarray(gm.drift(jnp.asarray(x[i]), float(t[i])))
                    for i in range(3)])
    out = gt.drift(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_chords_sample_quickstart_parity():
    """examples/quickstart.py: K=8, N=50, t_max 0.98 on a Gaussian mixture."""
    gm, gt = _gmm_pair()
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 16)))
    n, k = 50, 8
    i_seq = jinit.make_sequence(k, n)
    res_j = jchords.chords_sample(gm.drift, jnp.asarray(x0),
                                  jode.uniform_tgrid(n, 0.98), i_seq)
    res_t = tchords.chords_sample(gt.drift, torch.from_numpy(x0),
                                  tode.uniform_tgrid(n, 0.98), i_seq,
                                  device="cpu")
    np.testing.assert_allclose(res_t.outputs.numpy(),
                               np.asarray(res_j.outputs), atol=1e-5)
    np.testing.assert_array_equal(res_t.emit_rounds, res_j.emit_rounds)
    for rtol in (0.05, 0.02, 0.1, 1e-3):
        assert tchords.select_output(res_t, rtol) == \
            jchords.select_output(res_j, rtol)


def test_k1_equals_sequential_solve():
    _, gt = _gmm_pair(seed=3, modes=4, dim=8)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8)).astype(np.float32))
    tg = tode.uniform_tgrid(20, 0.98)
    res = tchords.chords_sample(gt.drift, x0, tg, [0], device="cpu")
    seq = sequential_sample(gt.drift, x0, tg, device="cpu")
    assert torch.equal(res.outputs[0], seq)


def test_slot_round_matches_per_slot_batch_rounds():
    """Two slots with their own init sequences and rounds advance exactly
    like two independent single-slot grids."""
    _, gt = _gmm_pair(seed=2, modes=4, dim=8)
    n, k = 12, 4
    tg = tode.uniform_tgrid(n, 0.98)
    seqs = [[0, 2, 4, 8], [0, 1, 3, 6]]
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8)).astype(np.float32))
    slot_round = tchords.make_slot_round_body(gt.drift, tg, n, k)
    carry = tchords.slot_init_carry(2, k, (8,))
    i_arr = torch.as_tensor(seqs, dtype=torch.int32)
    carry = tchords.reset_slots(carry, torch.tensor([True, True]), x0, i_arr)
    live = torch.tensor([True, True])
    for r in range(1, n + 1):
        carry, _ = slot_round(carry, i_arr, torch.tensor([r, r]), live)
    for s in range(2):
        res = tchords.chords_sample(gt.drift, x0[s], tg, seqs[s],
                                    device="cpu")
        assert torch.equal(carry.finals[s], res.outputs)
