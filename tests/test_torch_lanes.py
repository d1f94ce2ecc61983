"""Heterogeneous lanes in the port (``ContinuousEngine(lane_profile=...)``,
``Request.mode``) on the CPU, after the reference's
``tests/test_lane_modes.py``.

The pooling helpers and ``draft_drift`` equal the JAX package's values on
the same inputs; the default profile and the validation errors match.
``mode="exact"`` is bitwise the homogeneous engine, and rtol 0 is the exact
sequential solve in every mode. In ``adaptive`` and ``draft`` the port's
skips, rounds and accepted cores equal the JAX engine's exactly on the same
requests (noise injected through ``Request.x0``) and its samples are within
1e-4 (the serve parity tolerance of ``tests/test_torch_serve.py``), on the
closed-form drift and through the micro DiT and the micro hybrid. Skips are
deterministic between the synchronous and the overlap loop, and a rolled
back speculative step leaves no lane instants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import uniform_tgrid as j_tgrid
from repro.core import chords as jC
from repro.core import rectify as jR
from repro.core import solvers as jS
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro_torch.core import chords as C
from repro_torch.core import rectify as R
from repro_torch.core import solvers as S
from repro_torch.core.ode import uniform_tgrid
from repro_torch.serve import ContinuousEngine, Request

N, K = 16, 4
LAM = np.linspace(0.1, 1.5, 4).astype(np.float32)
J_LAM, T_LAM = jnp.asarray(LAM), torch.from_numpy(LAM)
ERR_ADAPTIVE, ERR_DRAFT = 0.05, 0.15  # the reference's stated bounds


def drift(x, t):
    return -x * T_LAM


def jdrift(x, t):
    return -x * J_LAM


def _x0(seed, shape=(4,)):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


def run_engine(mode, profile, rtol=0.25, overlap=False, n_req=4,
               num_slots=2, **kw):
    eng = ContinuousEngine(drift, (4,), N, K, uniform_tgrid(N, 0.98),
                           num_slots=num_slots, rtol=rtol,
                           lane_profile=profile, overlap=overlap,
                           device="cpu", **kw)
    for i in range(n_req):
        eng.submit(Request(rid=i, seed=i, x0=_x0(i), mode=mode))
    with torch.no_grad():
        return eng, dict(eng.run_until_drained())


def run_jax(mode, profile, rtol=0.25, overlap=False, n_req=4, num_slots=2,
            **kw):
    eng = JContinuousEngine(jdrift, (4,), N, K, j_tgrid(N, 0.98),
                            num_slots=num_slots, rtol=rtol,
                            lane_profile=profile, overlap=overlap, **kw)
    for i in range(n_req):
        eng.submit(JRequest(rid=i, key=jax.random.PRNGKey(i), mode=mode))
    return eng, dict(eng.run_until_drained())


def _np(gen, *shape):
    return gen.standard_normal(shape).astype(np.float32)


# --- coarse/fine resample pair -----------------------------------------------

@pytest.mark.parametrize("shape,factor", [((3, 8), 2), ((7,), 2),
                                          ((2, 5, 9), 3), ((4, 6), 1)])
def test_downsample_upsample_match_jax(shape, factor):
    """Shapes, off-multiple edge padding, factor 1 the identity, and the
    values of the reference's helpers on the same array."""
    x = _np(np.random.default_rng(0), *shape)
    tx = torch.from_numpy(x)
    down = R.downsample_latent(tx, factor)
    np.testing.assert_array_equal(
        down.numpy(), np.asarray(jR.downsample_latent(jnp.asarray(x),
                                                      factor)))
    up = R.upsample_latent(down, factor, shape[-1])
    assert tuple(up.shape) == shape
    np.testing.assert_array_equal(
        R.coarse_smooth(tx, factor).numpy(),
        np.asarray(jR.coarse_smooth(jnp.asarray(x), factor)))
    if factor == 1:
        assert R.coarse_smooth(tx, 1) is tx


def test_coarse_smooth_is_idempotent():
    x = torch.from_numpy(_np(np.random.default_rng(2), 2, 8))
    once = R.coarse_smooth(x, 2)
    assert torch.equal(R.coarse_smooth(once, 2), once)


def test_draft_drift_matches_jax_and_converges():
    x = _np(np.random.default_rng(3), 4)
    t = np.float32(0.3)
    cheap = S.draft_drift(drift, 2)
    got = cheap(torch.from_numpy(x)[None], torch.tensor([t]))[0]
    want = jS.draft_drift(jdrift, 2)(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert S.draft_drift(drift, 1) is drift
    exact = S.sequential_sample(drift, x, uniform_tgrid(N, 0.98),
                                device="cpu")
    crude = S.sequential_sample(cheap, x, uniform_tgrid(N, 0.98),
                                device="cpu")
    rel = float(torch.linalg.norm(crude - exact) / torch.linalg.norm(exact))
    assert 0.0 < rel < 1.0 and np.isfinite(rel), rel


# --- lane profile validation -------------------------------------------------

def test_default_lane_profile_matches_jax():
    for k in range(1, 10):
        got = C.default_lane_profile(k)
        want = jC.default_lane_profile(k)
        assert [(sp.role, sp.coarse_factor, sp.skip) for sp in got] == \
            [(sp.role, sp.coarse_factor, sp.skip) for sp in want]
    prof = C.default_lane_profile(4)
    assert prof[0].role == "refine" and not prof[0].skip
    assert prof[-1].role == "draft" and prof[-1].coarse_factor > 1


@pytest.mark.parametrize("k,profile,match", [
    (2, ((dict(role="draft", coarse_factor=2)), {}), "core 0"),
    (2, (dict(skip=True), {}), "core 0"),
    (3, ({}, dict(role="draft", coarse_factor=2),
         dict(role="draft", coarse_factor=4)), "coarse_factor"),
    (4, ({}, {}), "specs")])
def test_lane_profile_validation_errors(k, profile, match):
    """The same refusals, with the same messages, as the reference."""
    tg = uniform_tgrid(N, 0.98)
    with pytest.raises(ValueError, match=match) as got:
        C.make_slot_round_body(drift, tg, N, k, lane_profile=tuple(
            C.LaneSpec(**sp) for sp in profile))
    with pytest.raises(ValueError, match=match) as want:
        jC.make_slot_round_body(jdrift, j_tgrid(N, 0.98), N, k,
                                lane_profile=tuple(jC.LaneSpec(**sp)
                                                   for sp in profile))
    assert str(got.value) == str(want.value)


# --- exact mode and rtol 0 ---------------------------------------------------

@pytest.mark.parametrize("rtol", [0.0, 0.25])
def test_exact_mode_bitwise_identical_to_homogeneous(rtol):
    _, base = run_engine("exact", None, rtol=rtol)
    eng, out = run_engine("exact", "default", rtol=rtol)
    assert sorted(out) == sorted(base)
    for rid, o in out.items():
        assert o.rounds_used == base[rid].rounds_used, rid
        assert torch.equal(o.sample, base[rid].sample), rid
    st = eng.stats()
    assert st["lane_skips"] == 0 and st["lane_served_nonexact"] == 0


@pytest.mark.parametrize("mode", ["adaptive", "draft"])
def test_rtol0_force_accept_is_exact_in_every_mode(mode):
    _, base = run_engine("exact", None, rtol=0.0, n_req=2)
    _, out = run_engine(mode, "default", rtol=0.0, n_req=2)
    for rid, o in out.items():
        assert o.rounds_used == N and o.accepted_core == 0, rid
        assert torch.equal(o.sample, base[rid].sample), rid


# --- the modes against the JAX engine ----------------------------------------

LANE_COUNTS = ("lane_skips", "lane_served_nonexact", "lane_promotes",
               "rounds_total", "served", "host_syncs", "wasted_slot_rounds",
               "lane_profile", "lane_modes_enabled", "speculations",
               "speculation_rollbacks")


def _assert_lane_parity(jrun, trun):
    (je, out_j), (te, out_t) = jrun, trun
    assert sorted(out_j) == sorted(out_t)
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core, b.latency_rounds) == \
            (a.rounds_used, a.accepted_core, a.latency_rounds), rid
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    st_j, st_t = je.stats(), te.stats()
    for key in LANE_COUNTS:
        assert st_t[key] == st_j[key], (key, st_t[key], st_j[key])
    assert st_t["lane_skip_rate"] == pytest.approx(st_j["lane_skip_rate"],
                                                   rel=1e-12)
    assert set(st_t) == set(st_j) | {"programs"}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", ["adaptive", "draft"])
@pytest.mark.parametrize("rtol", [0.1, 0.3])
def test_modes_match_jax(mode, rtol, overlap):
    """Skips, rounds, cores and the lane counts exact; samples 1e-4."""
    kw = dict(rtol=rtol, n_req=6, overlap=overlap)
    jrun = run_jax(mode, "default", **kw)
    trun = run_engine(mode, "default", **kw)
    _assert_lane_parity(jrun, trun)
    assert trun[0].stats()["lane_skips"] > 0


@pytest.mark.parametrize("rtol", [0.1, 0.3])
def test_mode_error_bounds_analytic(rtol):
    """The reference's stated bounds hold for the port (5 % adaptive, 15 %
    draft), and the non-exact modes finish in fewer mean rounds."""
    _, base = run_engine("exact", None, rtol=rtol)
    _, exact = run_engine("exact", "default", rtol=rtol)
    eng_a, adapt = run_engine("adaptive", "default", rtol=rtol)
    _, dr = run_engine("draft", "default", rtol=rtol)
    assert eng_a.stats()["lane_skips"] > 0
    for rid in base:
        ref = base[rid].sample
        nrm = max(float(torch.linalg.norm(ref)), 1e-12)
        ea = float(torch.linalg.norm(adapt[rid].sample - ref)) / nrm
        ed = float(torch.linalg.norm(dr[rid].sample - ref)) / nrm
        assert ea <= ERR_ADAPTIVE, (rid, rtol, ea)
        assert ed <= ERR_DRAFT, (rid, rtol, ed)

    def mean(out):
        return float(np.mean([o.rounds_used for o in out.values()]))

    assert mean(adapt) < mean(exact) and mean(dr) < mean(exact)


ARCHS = ["chords-dit-xl", "zamba2-2.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def backbone(request):
    """The reduced denoiser of ``arch`` in both packages, with the same
    parameters (``out_proj`` drawn at fan-in scale: its zero init would
    make the drift vanish)."""
    from repro.configs import get_config as j_get_config
    from repro.diffusion import init_wrapper as j_init_wrapper
    from repro.diffusion import make_drift as j_make_drift
    from repro_torch.configs import get_config
    from repro_torch.diffusion import init_wrapper, make_drift
    from repro_torch.utils.convert import load_jax_params
    arch, latent = request.param, 8
    jcfg = j_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    params = dict(j_init_wrapper(jcfg, latent, jax.random.PRNGKey(2)))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(init_wrapper(tcfg, latent, device="cpu"),
                              jax.tree_util.tree_map(np.array, params))
    return arch, j_make_drift(params, jcfg), make_drift(tparams, tcfg)


def test_modes_through_backbone_match_jax(backbone):
    """The slice as a whole: the reduced denoiser served by both packages'
    lane engines (K 4, N 8, rtol 0.3, one slot, two requests) in every
    mode; exact mode bitwise the port's homogeneous engine."""
    arch, jd, td = backbone
    n, k, rtol, shape = 8, 4, 0.3, (1, 16, 8)

    def run(pkg, mode, profile):
        if pkg == "jax":
            eng = JContinuousEngine(jd, shape, n, k, j_tgrid(n, 0.98),
                                    num_slots=1, rtol=rtol,
                                    lane_profile=profile)
            reqs = [JRequest(rid=i, key=jax.random.PRNGKey(10 + i),
                             mode=mode) for i in range(2)]
        else:
            eng = ContinuousEngine(td, shape, n, k, uniform_tgrid(n, 0.98),
                                   num_slots=1, rtol=rtol,
                                   lane_profile=profile, device="cpu")
            reqs = [Request(rid=i, seed=10 + i, x0=_x0(10 + i, shape),
                            mode=mode) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        with torch.no_grad():
            return eng, dict(eng.run_until_drained())

    _, base = run("torch", "exact", None)
    _, exact = run("torch", "exact", "default")
    for rid in base:
        assert torch.equal(exact[rid].sample, base[rid].sample), (arch, rid)
    skips = 0
    for mode in ("adaptive", "draft"):
        jrun, trun = run("jax", mode, "default"), run("torch", mode,
                                                      "default")
        _assert_lane_parity(jrun, trun)
        skips += trun[0].stats()["lane_skips"]
    assert skips > 0, arch


# --- determinism, trace commits, pricing -------------------------------------

def test_skip_determinism_sync_vs_overlap():
    kw = dict(rtol=0.25, n_req=6, num_slots=2)
    es, sync = run_engine("adaptive", "default", **kw)
    eo, over = run_engine("adaptive", "default", overlap=True, **kw)
    assert sorted(sync) == sorted(over)
    for rid, o in sync.items():
        assert o.rounds_used == over[rid].rounds_used, rid
        assert torch.equal(o.sample, over[rid].sample), rid
    ss, so = es.stats(), eo.stats()
    assert ss["lane_skips"] == so["lane_skips"] > 0
    assert ss["lane_served_nonexact"] == so["lane_served_nonexact"] == 6


def test_no_phantom_lane_instants_after_rollback(tmp_path):
    """rtol 1e-5: cold-start predictions undershoot, speculative admissions
    roll back, and the lane instants still name only drained requests
    (they are emitted at the drain commit alone)."""
    from repro_torch.obs import Tracer
    from repro_torch.obs.check import check as obs_check
    eng, out = run_engine("adaptive", "default", rtol=1e-5, n_req=6,
                          num_slots=2, overlap=True, tracer=Tracer())
    assert len(out) == 6
    assert eng.stats()["speculation_rollbacks"] >= 1
    doc = eng.write_trace(str(tmp_path / "lane_rollback_trace.json"))
    lane_rids = {e["args"]["rid"] for e in doc["traceEvents"]
                 if e.get("ph") == "i" and e["name"].startswith("lane/")}
    assert lane_rids and lane_rids <= set(out)
    ok, report = obs_check(doc)
    assert ok, report


def test_cost_model_mode_cold_start_falls_back_through_aggregate():
    from repro_torch.serve.sched.cost import CostModel
    cm = CostModel(K, N)
    seq = cm.seq_for_level(0)  # [0, 3, 5, 10] -> emit [16, 14, 13, 9]
    assert cm.predict_rounds(seq, 0.3, mode="exact") == 13
    assert cm.predict_rounds(seq, 0.3, mode="adaptive") == 13
    cm.observe_accept(seq, 0.3, 10, mode="exact")
    assert cm.predict_rounds(seq, 0.3, mode="exact") == 13
    assert cm.predict_rounds(seq, 0.3, mode="adaptive") == 10
    cm.observe_skips("adaptive", 5, 10)
    assert cm.skip_rate("adaptive") == pytest.approx(0.5)
    assert cm.predict_rounds(seq, 0.3, mode="adaptive") == round(10 / 1.5)
    cm.observe_accept(seq, 0.3, 8, mode="adaptive")
    assert cm.predict_rounds(seq, 0.3, mode="adaptive") == 8
    cm.observe_skips("exact", 99, 1)
    assert cm.skip_rate("exact") == 0.0
    cm.observe_accept(seq, 0.0, 5, mode="draft")
    assert cm.predict_rounds(seq, 0.0, mode="draft") == N


def test_policy_request_mode_requires_engine_opt_in():
    from repro_torch.serve.sched.cost import CostModel
    from repro_torch.serve.sched.policy import EngineView, request_mode
    from repro_torch.serve.sched.queue import AdmissionQueue
    q = AdmissionQueue()
    q.submit(Request(rid=0, seed=0, mode="draft"), priority=0,
             submit_round=0, rtol=0.3)
    item = q.pop(now=0)
    cm = CostModel(K, N)
    on = EngineView(now=0, queue=q, free_slots=[0], lanes=[], cost=cm,
                    lane_modes=True)
    off = EngineView(now=0, queue=q, free_slots=[0], lanes=[], cost=cm,
                     lane_modes=False)
    assert request_mode(on, item) == "draft"
    assert request_mode(off, item) == "exact"
    # and a homogeneous engine serves (and prices) a draft request exact
    eng, out = run_engine("draft", None, n_req=1)
    assert eng.stats()["lane_served_nonexact"] == 0


def test_lane_gates_stay_on_the_device():
    """The gates ride the grid's state: an exact admission writes zeros, a
    draft one the draft flag and the engine's tau, and a round reads them
    from the state (nothing else changes between admissions)."""
    eng = ContinuousEngine(drift, (4,), N, K, uniform_tgrid(N, 0.98),
                           num_slots=3, lane_profile="default",
                           lane_skip_tau=0.375, device="cpu")
    for i, mode in enumerate(("exact", "adaptive", "draft")):
        eng.submit(Request(rid=i, seed=i, mode=mode))
    with torch.no_grad():
        eng.step()
    lanes = eng.state.lanes
    assert lanes.draft_on.tolist() == [False, False, True]
    assert lanes.skip_tau.tolist() == [0.0, 0.375, 0.375]
    assert eng._slot_mode == ["exact", "adaptive", "draft"]
