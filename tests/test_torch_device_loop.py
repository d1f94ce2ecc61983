"""The multi-round device loop (``step(max_rounds_on_device=R)``, the grid
programs ``multi`` and ``roll``) on the CPU, where the port runs its eager
programs: the plain version that the CUDA graphs are held to on the card
(``tests/test_torch_kernels_gpu.py``).

First the condition kernel's plain version against the reference's loop
conditions, then the programs (``roll`` is the k-fold ``round`` bitwise,
``multi`` leaves at the first new accept and honours
``GridSpec.device_rounds``), then the engines against the JAX package on
the SLA trace of ``serve/sched/workload.py`` at R in {1, 2, 8, 64}, sync
and overlap: rounds, host syncs, each request's rounds, core and latency,
and the speculation counts exactly; samples within 1e-4, the serve parity
tolerance of ``tests/test_torch_serve.py``. Within the port, samples at
R = 8 are bitwise those at R = 1.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uniform_tgrid as j_tgrid
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve.sched import workload as jwl
from repro_torch.core.init_sequence import make_sequence
from repro_torch.core.ode import uniform_tgrid
from repro_torch.kernels.device_loop import ops as loop_ops
from repro_torch.kernels.device_loop.ref import (EXIT_ON_ACCEPT, FIRST,
                                                 loop_cond, loop_step_ref)
from repro_torch.serve import ContinuousEngine, Request
from repro_torch.serve.executor import GridSpec, RoundExecutor
from repro_torch.serve.graphs import copy_state
from repro_torch.serve.sched import workload as twl

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K = 16, 4
LAM = np.linspace(0.1, 1.5, 4).astype(np.float32)
J_LAM, T_LAM = jnp.asarray(LAM), torch.from_numpy(LAM)


def _tdrift(x, t):
    return -x * T_LAM


def _jdrift(x, t):
    return -x * J_LAM


# -- the condition kernel's plain version ---------------------------------------


@pytest.mark.parametrize("s", [1, 4, 64])
def test_loop_condition_matches_reference(s):
    """``loop_step_ref`` (what the kernel computes) against the cond of the
    reference's ``multi_fn``/``roll_fn`` on random flags: entry, then steps
    with done rising and live falling."""
    rng = np.random.default_rng(s)
    live = rng.random(s) < 0.5
    done = rng.random(s) < 0.3
    done0 = np.zeros(s, bool)
    for exit_on_accept in (True, False):
        flags = EXIT_ON_ACCEPT if exit_on_accept else 0
        budget = 5
        ctrl = torch.tensor([budget, 7, 9, 0], dtype=torch.int32)
        d0 = torch.from_numpy(done0.copy())
        lv, dn = torch.from_numpy(live.copy()), torch.from_numpy(done.copy())
        go = loop_step_ref(lv, dn, d0, ctrl, flags | FIRST)
        entry = np.asarray(done)
        assert torch.equal(d0, dn) and int(ctrl[1]) == 0
        assert int(ctrl[2]) == 9  # the entry counts no round
        assert bool(go) == bool(jnp.any(jnp.asarray(live)))
        for i in range(1, 8):
            lv = torch.from_numpy(rng.random(s) < 0.6)
            dn = torch.from_numpy(entry | (rng.random(s) < 0.1))
            go = loop_step_ref(lv, dn, d0, ctrl, flags)
            jl, jd, j0 = (jnp.asarray(a.numpy()) for a in (lv, dn, d0))
            want = (i < budget) & jnp.any(jl)
            if exit_on_accept:
                want = want & ~jnp.any(jd & ~j0)
            assert bool(go) == bool(want), (s, i, exit_on_accept)
            assert int(ctrl[1]) == i and int(ctrl[2]) == 9 + i
            assert int(ctrl[3]) == int(bool(want))
            assert bool(loop_cond(torch.tensor(i), torch.tensor(budget), lv,
                                  dn, d0, exit_on_accept)) == bool(want)


def test_loop_condition_dispatch_on_cpu_is_the_plain_version():
    live = torch.tensor([True, False, True])
    done = torch.tensor([False, True, False])
    for use_kernel in (True, False):
        d0 = torch.zeros(3, dtype=torch.bool)
        ctrl = torch.tensor([2, 0, 0, 0], dtype=torch.int32)
        assert int(loop_ops.loop_step(live, done, d0, ctrl, FIRST,
                                      use_kernel=use_kernel)) == 1
        assert torch.equal(d0, done)


# -- the grid programs --------------------------------------------------------


def _admitted(spec, executor=None, slots_rtol=0.3):
    """A grid with every slot admitted (noise from numpy)."""
    ex = executor or RoundExecutor(_tdrift, uniform_tgrid(N, 0.98), N)
    progs = ex.grid(spec)
    s = spec.num_slots
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal(
        (s,) + spec.latent_shape).astype(np.float32))
    i_arr = torch.tensor([make_sequence(spec.num_cores, N)] * s,
                         dtype=torch.int32)
    rtol = torch.tensor(np.linspace(0.0, slots_rtol, s), dtype=torch.float32)
    st = progs.admit(progs.init_state(), torch.ones(s, dtype=torch.bool), x0,
                     i_arr, rtol)
    return ex, progs, st


def _state_equal(a, b):
    from repro_torch.serve.executor import state_tensors
    return all(torch.equal(x, y) for x, y in zip(state_tensors(a),
                                                  state_tensors(b)))


@pytest.mark.parametrize("k", [1, 3, 7, 40])
def test_roll_is_k_fold_round_bitwise(k):
    """k = 40 runs past every lane's accept: the loop stops when no lane is
    live, and the state is still bitwise the 40-fold round."""
    _, progs, st = _admitted(GridSpec(3, K, (4,)))
    want = st
    for _ in range(k):
        want = progs.round(want)
    got = progs.roll(st, k)
    assert _state_equal(got, want)


def test_multi_exits_at_first_new_accept():
    """``multi`` with a budget of 64 stops at the round the first lane
    accepts (walked round by round here); a second call runs on to the next
    accept; a lane drained earlier keeps its stale done flag, which does
    not stop the loop."""
    _, progs, st = _admitted(GridSpec(3, K, (4,)))
    walk, first = st, None
    for r in range(1, N + 1):
        walk = progs.round(walk)
        if bool(walk.done.any()):
            first = r
            break
    got, ran = progs.multi(st, 64)
    assert int(ran) == first
    assert _state_equal(got, walk)
    done_at = got.done.clone()
    got2, ran2 = progs.multi(got, 64)
    assert int(ran2) >= 1
    assert bool((got2.done & ~done_at).any()) or not bool(got2.live.any())
    _, ran3 = progs.multi(got2, 0)
    assert int(ran3) == 0


def test_grid_spec_device_rounds_caps_multi():
    """The static cap wins over a larger budget, is part of the cache key,
    and a budget below it is honoured."""
    ex, progs, st = _admitted(GridSpec(2, K, (4,), device_rounds=3),
                              slots_rtol=0.0)
    _, ran = progs.multi(st, 64)
    assert int(ran) == 3
    _, ran = progs.multi(st, 2)
    assert int(ran) == 2
    assert ex.retraces == 1
    ex.grid(GridSpec(2, K, (4,)))
    assert ex.retraces == 2
    assert GridSpec(2, K, (4,)) != GridSpec(2, K, (4,), device_rounds=3)


def test_eager_programs_keep_and_restore_are_the_state():
    """On the eager path the programs never write their inputs, so the
    rollback anchor is the state itself."""
    _, progs, st = _admitted(GridSpec(2, K, (4,)))
    kept = progs.keep(st)
    assert kept is st
    after = progs.round(st)
    assert progs.restore(kept) is st and not _state_equal(after, st)
    assert progs.graphs is None


def test_cpu_executor_runs_the_eager_programs():
    for eager in (False, True):
        assert RoundExecutor(_tdrift, uniform_tgrid(N), N,
                             eager=eager).programs == "eager"


def test_copy_state_is_bitwise():
    _, progs, st = _admitted(GridSpec(2, K, (4,)))
    nxt = progs.round(st)
    dst = progs.init_state()
    assert copy_state(dst, nxt) is dst and _state_equal(dst, nxt)


# -- the engines against the JAX package --------------------------------------


def _x0_requests(t_reqs, shape):
    """The port's requests with the reference's admission noise."""
    for r in t_reqs:
        r.x0 = np.array(jax.random.normal(jax.random.PRNGKey(r.seed), shape))
    return t_reqs


COUNTS = ("served", "rounds_total", "host_syncs", "dispatches",
          "speculations", "speculation_confirms", "speculation_rollbacks",
          "speculated_rounds_wasted", "drain_lag_rounds", "preemptions",
          "preempted_rounds_wasted", "deadline_misses", "deadline_total",
          "wasted_slot_rounds", "overlap")


def _serve_both(jdrift, tdrift, shape, n, k, policy, overlap, r_dev,
                rtol=0.05, num_slots=2, trace_rtol=0.0, **trace_kw):
    j_reqs, arr = jwl.sla_demo_trace(n, rtol=trace_rtol, **trace_kw)
    t_reqs, _ = twl.sla_demo_trace(n, rtol=trace_rtol, **trace_kw)
    kw = dict(num_slots=num_slots, rtol=rtol, policy=policy,
              overlap=overlap, **jwl.sla_engine_kwargs(n))
    je = JContinuousEngine(jdrift, shape, n, k, j_tgrid(n, 0.98), **kw)
    te = ContinuousEngine(tdrift, shape, n, k, uniform_tgrid(n, 0.98),
                          device="cpu", **kw)
    out_j = jwl.drive(je, j_reqs, arr, max_rounds_on_device=r_dev)
    with torch.no_grad():
        out_t = twl.drive(te, _x0_requests(t_reqs, shape), arr,
                          max_rounds_on_device=r_dev)
    return (out_j, je.stats()), (out_t, te.stats())


def _assert_parity(jrun, trun):
    (out_j, st_j), (out_t, st_t) = jrun, trun
    assert sorted(out_j) == sorted(out_t)
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core, b.latency_rounds) == \
            (a.rounds_used, a.accepted_core, a.latency_rounds), rid
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    for key in COUNTS:
        assert st_t[key] == st_j[key], (key, st_t[key], st_j[key])


@pytest.mark.parametrize("r_dev", [1, 2, 8, 64])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("policy", ["fifo", "edf-preempt"])
def test_engine_device_rounds_match_jax(policy, overlap, r_dev):
    jrun, trun = _serve_both(_jdrift, _tdrift, (4,), N, K, policy, overlap,
                             r_dev)
    _assert_parity(jrun, trun)
    st = trun[1]
    if r_dev > 1 and not overlap:
        assert st["host_syncs"] < st["rounds_total"]
    if overlap:
        assert st["speculation_rollbacks"] == 0  # trace rtol 0


@pytest.mark.parametrize("r_dev", [1, 8])
def test_overlap_rollbacks_with_device_rounds_match_jax(r_dev):
    """The tight-rtol rollback trace: rolls on the fast path, rollbacks
    at the event steps, the same in both packages."""
    jrun, trun = _serve_both(_jdrift, _tdrift, (4,), N, K, "edf-preempt",
                             True, r_dev, rtol=1e-9, num_slots=1,
                             trace_rtol=1e-9, bulk=2, urgent=1, soft=1)
    _assert_parity(jrun, trun)
    assert trun[1]["speculation_rollbacks"] >= 1


# -- ports of the reference's device-loop tests (tests/test_sched_engine.py) ---


def _engine(policy="fifo", num_slots=2, rtol=0.3, **kw):
    return ContinuousEngine(_tdrift, (4,), N, K, uniform_tgrid(N, 0.98),
                            num_slots=num_slots, policy=policy, rtol=rtol,
                            device="cpu", **kw)


def test_multi_round_device_loop_fewer_syncs_same_bits():
    """R=8 on a busy grid: at least 2x fewer host syncs than rounds,
    outputs bitwise identical to R=1."""
    outs, engines = {}, {}
    for r_dev in (1, 8):
        eng = _engine("fifo", num_slots=2)
        for i in range(6):
            eng.submit(Request(rid=i, seed=500 + i))
        outs[r_dev] = dict(eng.run_until_drained(max_rounds_on_device=r_dev))
        engines[r_dev] = eng
    e1, e8 = engines[1], engines[8]
    assert e1.round_count == e8.round_count
    assert e1.host_syncs == e1.round_count
    assert 2 * e8.host_syncs <= e8.round_count
    for rid in outs[1]:
        assert torch.equal(outs[1][rid].sample, outs[8][rid].sample)
        assert outs[1][rid].rounds_used == outs[8][rid].rounds_used


def test_device_loop_exits_on_finish_for_admission():
    """With a queued backlog the loop hands control back the moment a slot
    frees: back-to-back service, rid i finishes at (i + 1) * N."""
    eng = _engine("fifo", num_slots=1, rtol=0.0)
    for i in range(3):
        eng.submit(Request(rid=i, seed=i, rtol=0.0))
    served = eng.run_until_drained(max_rounds_on_device=64)
    assert {rid: out.latency_rounds for rid, out in served} == \
        {0: N, 1: 2 * N, 2: 3 * N}
    assert eng.round_count == 3 * N
    assert eng.host_syncs == 3


def test_device_loop_exits_for_admission_matches_jax():
    """The same backlog through the JAX engine: the same rounds, syncs and
    latencies."""
    je = JContinuousEngine(_jdrift, (4,), N, K, j_tgrid(N, 0.98),
                           num_slots=1, rtol=0.0)
    te = _engine("fifo", num_slots=1, rtol=0.0)
    for i in range(3):
        je.submit(JRequest(rid=i, key=jax.random.PRNGKey(i), rtol=0.0))
        te.submit(Request(rid=i, x0=np.array(jax.random.normal(
            jax.random.PRNGKey(i), (4,))), rtol=0.0))
    a = dict(je.run_until_drained(max_rounds_on_device=64))
    b = dict(te.run_until_drained(max_rounds_on_device=64))
    assert (te.round_count, te.host_syncs) == (je.round_count, je.host_syncs)
    for rid in a:
        assert b[rid].latency_rounds == a[rid].latency_rounds
        np.testing.assert_allclose(b[rid].sample.numpy(),
                                   np.asarray(a[rid].sample), atol=1e-4)


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_dispatches_counted_by_program_kind(overlap):
    """``serve.dispatches.<kind>`` splits ``dispatches`` by program: at
    R=8 the synchronous loop runs ``multi`` (and ``round`` only when the
    host has a decision to make between rounds), the overlap loop ``roll``
    on its fast path and never ``multi``."""
    eng = _engine("fifo", num_slots=2, overlap=overlap)
    for i in range(6):
        eng.submit(Request(rid=i, seed=500 + i))
    eng.run_until_drained(max_rounds_on_device=8)
    m = eng.metrics
    kinds = {kind: int(m[f"serve.dispatches.{kind}"].value)
             if f"serve.dispatches.{kind}" in m else 0
             for kind in ("round", "multi", "roll")}
    assert sum(kinds.values()) == eng.stats()["dispatches"]
    if overlap:
        assert kinds["roll"] > 0 and kinds["multi"] == 0
    else:
        assert kinds["multi"] > 0 and kinds["roll"] == 0


def test_launch_counts_read_zero_where_no_kernel_ran():
    """The kernels count their own launches on the device; on a host where
    no kernel library was loaded every count reads 0, and reading or
    resetting touches no device."""
    from repro_torch.kernels import COUNTERS, launch_counts, \
        reset_launch_counts
    from repro_torch.kernels import build
    assert not build._libs
    reset_launch_counts()
    assert launch_counts() == {name: 0 for name in COUNTERS}
    assert set(COUNTERS) == {"fused_step_rectify",
                             "fused_step_rectify_accept", "rmsnorm",
                             "flash_attention", "ssd_chunk", "device_loop"}


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_samples_at_r8_bitwise_r1(overlap):
    """Both loops, the SLA trace under EDF-preempt: R=8 serves every
    request bitwise as R=1 does, with the same rounds and core."""
    outs = {}
    for r_dev in (1, 8):
        eng = _engine("edf-preempt", overlap=overlap,
                      **twl.sla_engine_kwargs(N))
        reqs, arrivals = twl.sla_demo_trace(N, rtol=0.05)
        outs[r_dev] = twl.drive(eng, reqs, arrivals,
                                max_rounds_on_device=r_dev)
    for rid, a in outs[1].items():
        b = outs[8][rid]
        assert torch.equal(a.sample, b.sample), rid
        assert (a.rounds_used, a.accepted_core) == \
            (b.rounds_used, b.accepted_core)


# -- the slice as a whole -------------------------------------------------------


@pytest.fixture(scope="module")
def micro_dit():
    from repro.configs import get_config as j_get_config
    from repro.diffusion import init_wrapper as j_init_wrapper
    from repro.diffusion import make_drift as j_make_drift
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper, make_drift
    from repro_torch.utils.convert import load_jax_params
    latent = 8
    jcfg = j_get_config("chords-dit-xl", reduced=True)
    tcfg = get_config("chords-dit-xl", reduced=True)
    params = j_init_wrapper(jcfg, latent, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(
        init_wrapper(tcfg, latent, device="cpu"),
        jax.tree_util.tree_map(lambda a: np.array(a), params))
    return (j_make_drift(params, jcfg),
            make_drift(tparams, tcfg.replace(use_kernels=True)), latent)


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_micro_dit_device_rounds_match_jax(micro_dit, overlap):
    """The reduced ``chords-dit-xl`` denoiser (the same parameters in both
    packages, the port through its kernels' plain versions) over the SLA
    trace at R=8, with early accepts."""
    jdrift, tdrift, latent = micro_dit
    n = 12
    jrun, trun = _serve_both(jdrift, tdrift, (1, 16, latent), n, 4, "fifo",
                             overlap, 8, trace_rtol=None)
    _assert_parity(jrun, trun)
    assert trun[1]["host_syncs"] < trun[1]["rounds_total"]


@pytest.mark.parametrize("extra,expect", [
    (("--device-rounds", "8"), "device_rounds=8"),
    (("--device-rounds", "8", "--overlap", "--use-kernels"),
     "overlap=true"),
])
def test_launcher_device_rounds_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", *extra], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout and "served=8" in proc.stdout
    syncs = int(proc.stdout.split("host_syncs=")[1].split()[0])
    rounds = int(proc.stdout.split("rounds_total=")[1].split()[0])
    assert 2 * syncs <= rounds
