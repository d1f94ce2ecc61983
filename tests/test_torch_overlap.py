"""The port's overlap engine (``ContinuousEngine(overlap=True)``) on the CPU.

Ports of the speculation contract suite of ``tests/test_async_engine.py``
(the port against itself: overlap bitwise equal to sync, readbacks that
scale with completions, bounded rollbacks, a monotone gap timer), then the
port against the JAX package: the same SLA trace (``sched/workload.py``,
the port's noise injected from the reference's ``jax.random`` draws
through ``Request.x0``) served by both packages' overlap engines. Every
scheduling and speculation count is exact; samples agree within 1e-4, the
serve parity tolerance of ``tests/test_torch_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uniform_tgrid as j_tgrid
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve.sched import workload as jwl
from repro_torch.core.ode import uniform_tgrid
from repro_torch.serve import ContinuousEngine, Request
from repro_torch.serve.sched import workload as twl
from repro_torch.serve.sched.cost import CostModel

N, K = 16, 4
LAM = np.linspace(0.1, 1.5, 4).astype(np.float32)
J_LAM, T_LAM = jnp.asarray(LAM), torch.from_numpy(LAM)


def _tdrift(x, t):
    return -x * T_LAM


def _jdrift(x, t):
    return -x * J_LAM


def _engine(policy=None, overlap=False, num_slots=2, rtol=0.0, **kw):
    return ContinuousEngine(_tdrift, (4,), N, K, uniform_tgrid(N, 0.98),
                            num_slots=num_slots, rtol=rtol, policy=policy,
                            overlap=overlap, device="cpu", **kw)


def _same_result(a, b):
    return (torch.equal(a.sample, b.sample)
            and a.rounds_used == b.rounds_used
            and a.accepted_core == b.accepted_core
            and a.latency_rounds == b.latency_rounds)


# -- the port against itself --------------------------------------------------


@pytest.mark.parametrize("policy", ["fifo", "edf", "edf-preempt"])
def test_confirmed_speculation_bitwise_identical_to_sync(policy):
    """rtol=0: the cost model's done round is exact, so every speculative
    decision is the one the synchronous loop makes at the same round.
    Outputs, latencies and deadline stats identical; fewer readbacks."""
    runs = {}
    for overlap in (False, True):
        eng = _engine(policy=policy, overlap=overlap,
                      **twl.sla_engine_kwargs(N))
        reqs, arrivals = twl.sla_demo_trace(N)
        runs[overlap] = (twl.drive(eng, reqs, arrivals), eng.stats())
    sync_out, sync_st = runs[False]
    ovl_out, ovl_st = runs[True]
    assert sync_out.keys() == ovl_out.keys()
    for rid in sync_out:
        assert _same_result(sync_out[rid], ovl_out[rid]), rid
    for k in ("deadline_misses", "deadline_total", "preemptions",
              "rounds_total", "served"):
        assert sync_st[k] == ovl_st[k], k
    assert ovl_st["overlap"] and not sync_st["overlap"]
    assert ovl_st["speculation_rollbacks"] == 0
    assert ovl_st["host_syncs"] < sync_st["host_syncs"]
    # readbacks scale with completions, not rounds
    assert ovl_st["host_syncs"] <= ovl_st["served"] + \
        ovl_st["speculations"] + 1
    assert sync_st["host_syncs"] >= sync_st["rounds_total"] // 2


def test_fast_path_reads_nothing_back():
    """A lone rtol=0 request pays exactly ONE done-flag readback: the
    verify of its predicted accept round."""
    eng = _engine(overlap=True, num_slots=1)
    eng.submit(Request(rid=0, seed=5))
    out = dict(eng.run_until_drained())
    assert out[0].rounds_used == N
    assert eng.round_count == N
    assert eng.host_syncs == 1
    assert eng.metrics.gauge("serve.overlap").value == 1.0


def test_rollback_bounded_and_bitwise_correct():
    """Tight rtol: the accept fires only at the force-accept round N while
    the cold-start heuristic predicts the second arrival, so speculative
    re-admissions of the slot roll back until the lane really finishes.
    Wasted rounds are bounded, the clock never advances for them, and the
    outputs are bitwise the synchronous loop's."""
    rtol = 1e-9  # no two consecutive emissions agree this tightly

    def serve(overlap):
        eng = _engine(overlap=overlap, num_slots=1, rtol=rtol)
        for rid in (0, 1):
            eng.submit(Request(rid=rid, seed=rid))
        return dict(eng.run_until_drained()), eng

    ref, _ = serve(False)
    out, eng = serve(True)
    st = eng.stats()
    for rid in ref:
        assert _same_result(ref[rid], out[rid]), rid
    cold = CostModel(K, N)
    pred = cold.predict_rounds(cold.seq_for_level(0), rtol)
    assert pred < N  # the premise: the heuristic really is optimistic
    assert st["speculation_rollbacks"] >= 1
    assert st["speculated_rounds_wasted"] <= st["speculation_rollbacks"]
    assert st["speculation_rollbacks"] <= 2 * (N - pred)
    assert st["rounds_total"] == 2 * N


def test_round_gap_timer_monotone_and_sane():
    eng = _engine(overlap=True, num_slots=2)
    for rid in range(4):
        eng.submit(Request(rid=rid, seed=100 + rid))
    prev_count, prev_disp, prev_max = 0, 0, 0.0
    while len(eng.queue) or eng.has_inflight:
        eng.step()
        st = eng.stats()
        assert st["round_gap_count"] >= prev_count
        assert st["dispatches"] >= prev_disp
        assert st["round_gap_max_s"] >= prev_max >= 0.0
        assert st["round_gap_count"] <= st["dispatches"]
        if st["round_gap_count"]:
            assert 0.0 <= st["round_gap_mean_s"] <= st["round_gap_max_s"]
            assert st["round_gap_p95_s"] <= st["round_gap_max_s"]
        prev_count, prev_disp = st["round_gap_count"], st["dispatches"]
        prev_max = st["round_gap_max_s"]
    assert prev_count > 0


# -- the port against the JAX package -----------------------------------------


@pytest.mark.parametrize("trace,kw", [
    ("sla", {}), ("sla", {"rtol": None, "bulk": 5, "urgent": 3}),
    ("bursty", {}), ("bursty", {"burst": 3, "quiet": 2, "quiet_gap": 7})])
def test_workload_traces_match_jax(trace, kw):
    """Arrivals, rids, deadlines, tolerances and priorities exactly; the
    port's seed is the number the reference makes its PRNG key from."""
    fn = "sla_demo_trace" if trace == "sla" else "bursty_trace"
    base = 1000 if trace == "sla" else 7000
    j_reqs, j_arr = getattr(jwl, fn)(N, **kw)
    t_reqs, t_arr = getattr(twl, fn)(N, **kw)
    assert j_arr == t_arr and len(j_reqs) == len(t_reqs)
    for a, b in zip(j_reqs, t_reqs):
        assert (a.rid, a.rtol, a.deadline_rounds, a.priority) == \
            (b.rid, b.rtol, b.deadline_rounds, b.priority)
        assert b.seed == base + b.rid
        assert np.array_equal(np.asarray(a.key),
                              np.asarray(jax.random.PRNGKey(b.seed)))
    assert twl.sla_engine_kwargs(N) == jwl.sla_engine_kwargs(N)


def _x0_requests(t_reqs, shape):
    """The port's requests with the reference's admission noise (the JAX
    admit program draws ``jax.random.normal(key, latent)``)."""
    for r in t_reqs:
        r.x0 = np.array(jax.random.normal(jax.random.PRNGKey(r.seed), shape))
    return t_reqs


COUNTS = ("served", "rounds_total", "host_syncs", "speculations",
          "speculation_confirms", "speculation_rollbacks",
          "speculated_rounds_wasted", "drain_lag_rounds", "dispatches",
          "preemptions", "preempted_rounds_wasted", "deadline_misses",
          "deadline_total", "wasted_slot_rounds", "overlap")


def _serve_both(jdrift, tdrift, shape, n, k, policy, rtol, num_slots=2,
                trace_rtol=0.0, **trace_kw):
    j_reqs, arr = jwl.sla_demo_trace(n, rtol=trace_rtol, **trace_kw)
    t_reqs, _ = twl.sla_demo_trace(n, rtol=trace_rtol, **trace_kw)
    kw = dict(num_slots=num_slots, rtol=rtol, policy=policy, overlap=True,
              **jwl.sla_engine_kwargs(n))
    je = JContinuousEngine(jdrift, shape, n, k, j_tgrid(n, 0.98), **kw)
    te = ContinuousEngine(tdrift, shape, n, k, uniform_tgrid(n, 0.98),
                          device="cpu", **kw)
    out_j = jwl.drive(je, j_reqs, arr)
    with torch.no_grad():
        out_t = twl.drive(te, _x0_requests(t_reqs, shape), arr)
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
    # the port's one extra key names its grid programs (eager on the CPU)
    assert set(st_t) == set(st_j) | {"programs"}
    assert st_t["programs"] == "eager"


@pytest.mark.parametrize("policy", ["fifo", "edf", "edf-preempt"])
@pytest.mark.parametrize("trace_rtol", [0.0, 3e-3])
def test_overlap_matches_jax(policy, trace_rtol):
    """rtol 0: every speculation confirms. rtol 3e-3: accepts land after
    the cost model's predictions (rollbacks under every policy) and, under
    EDF-preempt, one before (a late drain); both packages must take the
    same steps."""
    jrun, trun = _serve_both(_jdrift, _tdrift, (4,), N, K, policy, 0.05,
                             trace_rtol=trace_rtol)
    _assert_parity(jrun, trun)
    st = trun[1]
    if trace_rtol == 0.0:
        assert st["speculation_rollbacks"] == 0
    else:
        assert st["speculation_rollbacks"] >= 1
        assert st["drain_lag_rounds"] >= (policy == "edf-preempt")


def test_overlap_rollbacks_match_jax():
    """The tight-rtol rollback trace: the same rollbacks, wasted rounds
    and accepts in both packages."""
    jrun, trun = _serve_both(_jdrift, _tdrift, (4,), N, K, "edf-preempt",
                             1e-9, num_slots=1, trace_rtol=1e-9, bulk=2,
                             urgent=1, soft=1)
    _assert_parity(jrun, trun)
    assert trun[1]["speculation_rollbacks"] >= 1


def test_overlap_micro_dit_matches_jax():
    """The slice as a whole: the reduced ``chords-dit-xl`` denoiser (the
    same parameters in both packages) served by both overlap engines over
    the SLA trace under EDF-preempt with early accepts."""
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
    n = 12
    jrun, trun = _serve_both(j_make_drift(params, jcfg),
                             make_drift(tparams, tcfg), (1, 16, latent), n,
                             4, "edf-preempt", 0.05, trace_rtol=None)
    _assert_parity(jrun, trun)
    assert trun[1]["preemptions"] >= 1
