"""Elastic capacity in the port (``ContinuousEngine(min_slots, max_slots)``)
on the CPU, after the reference's ``tests/test_executor.py``.

The port against itself: the bucket ladder, the bit-exact lane migration
(``core.chords.gather_slots``), ``min_slots == max_slots`` bit for bit the
fixed-S engine, a migrated lane bitwise the fresh engine's output, idle
page-out, the policy veto, the pinned ladder, and the overlap loop bitwise
the synchronous one across resizes at R 1 and 8. Then the port against the
JAX package on the bursty trace (``sched/workload.py``), the port's noise
injected from the reference's ``jax.random`` draws through ``Request.x0``:
every scheduling and resize count exact, each request's rounds and core
exact, samples within 1e-4 (the serve parity tolerance of
``tests/test_torch_serve.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uniform_tgrid as j_tgrid
from repro.core.chords import gather_slots as j_gather_slots
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import bucket_ladder as j_bucket_ladder
from repro.serve.sched import workload as jwl
from repro_torch.core.chords import gather_slots, slot_init_carry
from repro_torch.core.ode import uniform_tgrid
from repro_torch.serve import (ContinuousEngine, GridSpec, Request,
                               RoundExecutor)
from repro_torch.serve.engine import bucket_ladder
from repro_torch.serve.sched import workload as twl

N, K = 12, 4
LAM = np.linspace(0.1, 1.5, 4).astype(np.float32)
J_LAM, T_LAM = jnp.asarray(LAM), torch.from_numpy(LAM)


def _tdrift(x, t):
    return -x * T_LAM


def _jdrift(x, t):
    return -x * J_LAM


def _engine(**kw):
    kw.setdefault("rtol", 0.3)
    return ContinuousEngine(_tdrift, (4,), N, K, uniform_tgrid(N, 0.98),
                            device="cpu", **kw)


def _jengine(**kw):
    kw.setdefault("rtol", 0.3)
    return JContinuousEngine(_jdrift, (4,), N, K, j_tgrid(N, 0.98), **kw)


def _x0(seed, shape=(4,)):
    """The reference's admission noise for a request keyed by ``seed``."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def _req(rid, seed, **kw):
    return Request(rid=rid, seed=seed, x0=_x0(seed), **kw)


def _bursty(**trace_kw):
    reqs, arrivals = twl.bursty_trace(N, **trace_kw)
    for r in reqs:
        r.x0 = _x0(r.seed)
    return reqs, arrivals


def _run_bursty(r_dev=1, trace_rtol=0.0, **kw):
    eng = _engine(rtol=0.0 if trace_rtol == 0.0 else 0.3, **kw)
    with torch.no_grad():
        out = twl.drive(eng, *_bursty(burst=4, quiet=2, rtol=trace_rtol),
                        max_rounds_on_device=r_dev)
    return eng, out, eng.stats()


def _same(a, b):
    return (torch.equal(a.sample, b.sample)
            and (a.rounds_used, a.accepted_core, a.latency_rounds)
            == (b.rounds_used, b.accepted_core, b.latency_rounds))


# --- the ladder and the migration copy ---------------------------------------

@pytest.mark.parametrize("lo,hi", [(1, 8), (2, 12), (3, 3), (1, 1), (0, 4),
                                   (5, 4)])
def test_bucket_ladder(lo, hi):
    """Equal ladders, and the same refusals, as the reference."""
    try:
        want = j_bucket_ladder(lo, hi)
    except ValueError as e:
        with pytest.raises(ValueError, match="min_slots <= max_slots"):
            bucket_ladder(lo, hi)
        assert "min_slots <= max_slots" in str(e)
        return
    assert bucket_ladder(lo, hi) == want


def test_gather_slots_is_a_bit_exact_row_copy():
    """Rows copied bitwise, unmasked destination rows untouched, and the
    same result as the reference's gather on the same arrays."""
    gen = torch.Generator().manual_seed(0)
    src = slot_init_carry(2, K, (3,))
    src = src._replace(x=torch.randn(src.x.shape, generator=gen),
                       f_snap=torch.randn(src.f_snap.shape, generator=gen),
                       p=torch.arange(2 * K, dtype=torch.int32).reshape(2, K))
    dst = slot_init_carry(4, K, (3,))
    mask = torch.tensor([True, True, False, False])
    idx = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    out = gather_slots(dst, src, mask, idx)
    assert type(out) is type(dst)
    for leaf_out, leaf_src, leaf_dst in zip(out, src, dst):
        assert torch.equal(leaf_out[0], leaf_src[1])
        assert torch.equal(leaf_out[1], leaf_src[0])
        assert torch.equal(leaf_out[2:], leaf_dst[2:])
    j_out = j_gather_slots(tuple(jnp.asarray(t.numpy()) for t in dst),
                           tuple(jnp.asarray(t.numpy()) for t in src),
                           jnp.asarray(mask.numpy()),
                           jnp.asarray(idx.numpy()))
    for a, b in zip(out, j_out):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_migrate_refuses_grids_differing_beyond_s():
    ex = RoundExecutor(_tdrift, uniform_tgrid(N, 0.98), N)
    a = GridSpec(num_slots=2, num_cores=K, latent_shape=(4,))
    for b in (GridSpec(num_slots=4, num_cores=K - 1, latent_shape=(4,)),
              GridSpec(num_slots=4, num_cores=K, latent_shape=(5,)),
              GridSpec(num_slots=4, num_cores=K, latent_shape=(4,),
                       lane_profile=((None,) * K))):
        with pytest.raises(ValueError, match="differing in S"):
            ex.migrate(a, b)


def test_ladder_is_built_once_and_pinned():
    """Every bucket's grid is built at construction and pinned: a small
    ``max_entries`` grows to hold the ladder, later grids evict around it
    (least recently used first), and a cache full of pinned grids refuses
    a new one instead of evicting a ladder grid."""
    ex = RoundExecutor(_tdrift, uniform_tgrid(N, 0.98), N, max_entries=1)
    eng = _engine(min_slots=1, max_slots=4, executor=ex)
    assert ex.retraces == 3 and ex.max_entries == 3
    assert eng.stats()["retraces"] == 3
    progs = dict(eng._progs)
    with pytest.raises(RuntimeError, match="pinned"):
        ex.grid(GridSpec(num_slots=7, num_cores=K, latent_shape=(4,)))
    ex.reserve_grid_capacity(1)
    for s in (7, 9, 7):  # 9 evicts 7, which is then built again
        ex.grid(GridSpec(num_slots=s, num_cores=K, latent_shape=(4,)))
    assert ex.retraces == 6
    for b, p in progs.items():
        assert ex.grid(eng._spec(b)) is p
    assert ex.retraces == 6


# --- the elastic contract ----------------------------------------------------

def test_bursty_trace_retraces_bounded_by_buckets_visited():
    """grow -> shrink -> grow: re-entering a bucket builds nothing."""
    eng, out, st = _run_bursty(min_slots=1, max_slots=4,
                               resize_hysteresis=4)
    assert len(out) == 10  # a burst of 4, 2 in the lull, a burst of 4
    assert st["grows"] >= 2 and st["shrinks"] >= 1, st
    assert set(st["buckets_visited"]) == {1, 2, 4}
    assert st["retraces"] == len(st["buckets_visited"]), st
    assert eng.executor.migration_traces <= 2 * len(st["buckets_visited"])


def test_elastic_contract_vs_fixed_grids():
    """Fewer wasted slot-rounds than fixed S=max, p95 no worse than fixed
    S=min, every request bitwise the fixed S=4 run (migrated lanes too)."""
    el, e_out, e_st = _run_bursty(min_slots=1, max_slots=4,
                                  resize_hysteresis=4)
    _, fmax_out, fmax_st = _run_bursty(num_slots=4)
    _, _, fmin_st = _run_bursty(num_slots=1)
    assert e_st["wasted_slot_rounds"] < fmax_st["wasted_slot_rounds"]
    assert e_st["latency_rounds_p95"] <= fmin_st["latency_rounds_p95"]
    assert e_st["retraces"] <= len(e_st["buckets_visited"])
    assert len(el.migrated_rids) > 0
    assert sorted(e_out) == sorted(fmax_out)
    for rid in fmax_out:
        assert torch.equal(e_out[rid].sample, fmax_out[rid].sample), \
            (rid, rid in el.migrated_rids)
        assert e_out[rid].rounds_used == fmax_out[rid].rounds_used
        assert e_out[rid].accepted_core == fmax_out[rid].accepted_core


def test_min_equals_max_is_fixed_s_bit_for_bit():
    runs = {}
    for label, kw in (("fixed", dict(num_slots=2)),
                      ("pinned", dict(min_slots=2, max_slots=2))):
        eng = _engine(**kw)
        for i in range(5):
            eng.submit(_req(i, 500 + i))
        with torch.no_grad():
            runs[label] = (dict(eng.run_until_drained()), eng.stats())
    out_f, st_f = runs["fixed"]
    out_p, st_p = runs["pinned"]
    assert st_p["resizes"] == 0 and st_p["migrations"] == 0
    assert {k: v for k, v in st_f.items() if "gap" not in k} == \
        {k: v for k, v in st_p.items() if "gap" not in k}
    for rid in out_f:
        assert _same(out_f[rid], out_p[rid]), rid


def test_migrated_lane_equals_fresh_engine():
    """A request whose lane migrates mid-flight (a burst grows the grid
    under it) is bitwise the fresh engine's output."""
    eng = _engine(min_slots=1, max_slots=4, resize_hysteresis=2, rtol=0.0)
    eng.submit(_req(0, 900, rtol=0.0))
    with torch.no_grad():
        eng.step()
        for i in range(1, 4):
            eng.submit(_req(i, 900 + i, rtol=0.3))
        out = dict(eng.run_until_drained())
    assert 0 in eng.migrated_rids and eng.stats()["grows"] >= 1
    fresh = _engine(num_slots=1, rtol=0.0)
    fresh.submit(_req(0, 900, rtol=0.0))
    with torch.no_grad():
        [(_, ref)] = fresh.run_until_drained()
    assert torch.equal(out[0].sample, ref.sample)
    assert out[0].rounds_used == ref.rounds_used == N


def test_idle_engine_pages_slots_out():
    eng = _engine(min_slots=1, max_slots=4, resize_hysteresis=3, rtol=0.0)
    for i in range(4):
        eng.submit(_req(i, 800 + i, rtol=0.0))
    with torch.no_grad():
        eng.run_until_drained()
        assert eng.s == 4  # grew for the burst, drained before shrinking
        for _ in range(3 * eng.resize_hysteresis):  # idle serving loop
            assert eng.step() == []
    assert eng.s == 1, eng.stats()


def test_engine_counts_and_respects_resize_veto():
    eng = _engine(min_slots=1, max_slots=2, resize_hysteresis=2, rtol=0.0)
    proposals = []
    eng.policy.consider_resize = \
        lambda view, prop: proposals.append(prop) or None  # veto all
    eng.submit(_req(0, 700, rtol=0.0))
    eng.submit(_req(1, 701, rtol=0.5))
    with torch.no_grad():
        out = dict(eng.run_until_drained())
    assert len(out) == 2
    st = eng.stats()
    assert st["resize_vetoes"] >= 1 and proposals
    assert all(p.new_slots == 1 and p.current_slots == 2 for p in proposals)
    assert st["shrinks"] == 0 and st["num_slots"] == 2


@pytest.mark.parametrize("r_dev", [1, 8])
def test_elastic_overlap_bitwise_sync(r_dev):
    """The overlap loop resizes at the top of a step with a round possibly
    in flight: every request's sample, rounds, core and latency are the
    synchronous loop's, at R=1 and with multi-round programs (R=8). (Its
    shrinks may come at other rounds than the synchronous loop's, in the
    reference too, so the wasted slot-rounds and migrations may differ:
    ``test_elastic_bursty_matches_jax`` holds them to the reference's
    overlap engine.)"""
    _, sync, st_s = _run_bursty(min_slots=1, max_slots=4,
                                resize_hysteresis=4, r_dev=r_dev)
    _, over, st_o = _run_bursty(min_slots=1, max_slots=4,
                                resize_hysteresis=4, r_dev=r_dev,
                                overlap=True)
    assert sorted(sync) == sorted(over)
    for rid in sync:
        assert _same(sync[rid], over[rid]), rid
    for key in ("rounds_total", "buckets_visited", "served"):
        assert st_s[key] == st_o[key], (key, st_s[key], st_o[key])
    assert st_o["migrations"] > 0 and st_s["migrations"] > 0
    assert st_o["host_syncs"] < st_s["host_syncs"]


# --- the port against the JAX package ----------------------------------------

ELASTIC_COUNTS = ("rounds_total", "resizes", "grows", "shrinks",
                  "resize_vetoes", "migrations", "buckets_visited",
                  "wasted_slot_rounds", "latency_rounds_p95", "served",
                  "host_syncs", "dispatches", "num_slots", "min_slots",
                  "max_slots", "speculations", "speculation_rollbacks")


@pytest.mark.parametrize("r_dev", [1, 8])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("trace_rtol", [0.0, None])
def test_elastic_bursty_matches_jax(trace_rtol, overlap, r_dev):
    """The bursty trace at min 1 / max 4 / hysteresis 4: rtol 0 (every lane
    runs N rounds) and the engine's rtol 0.3 (early accepts), through both
    loops at R 1 and 8. Both packages take the same resizes and migrations,
    and each request the same rounds and core."""
    kw = dict(min_slots=1, max_slots=4, resize_hysteresis=4,
              overlap=overlap, rtol=0.0 if trace_rtol == 0.0 else 0.3)
    je = _jengine(**kw)
    out_j = jwl.drive(je, *jwl.bursty_trace(N, burst=4, quiet=2,
                                            rtol=trace_rtol),
                      max_rounds_on_device=r_dev)
    te = _engine(**kw)
    with torch.no_grad():
        out_t = twl.drive(te, *_bursty(burst=4, quiet=2, rtol=trace_rtol),
                          max_rounds_on_device=r_dev)
    st_j, st_t = je.stats(), te.stats()
    assert sorted(out_j) == sorted(out_t)
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core, b.latency_rounds) == \
            (a.rounds_used, a.accepted_core, a.latency_rounds), rid
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    for key in ELASTIC_COUNTS:
        assert st_t[key] == st_j[key], (key, st_t[key], st_j[key])
    assert te.migrated_rids == je.migrated_rids
    assert st_t["migrations"] > 0 and st_t["shrinks"] >= 1
    assert st_t["migration_traces"] == st_j["migration_traces"]
    assert set(st_t) == set(st_j) | {"programs"}
