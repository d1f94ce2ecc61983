"""The serving slice end to end, JAX package vs port (CPU): the same
requests — the port's noise injected from the reference's ``jax.random``
draws through ``Request.x0`` — served by both packages' engines over the
same micro-DiT parameters. Scheduling is exact (per-request rounds and
accepted core, the ``stats()`` counts); samples agree within 1e-4."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.ode import uniform_tgrid as j_tgrid
from repro.diffusion import init_wrapper as j_init_wrapper
from repro.diffusion import make_drift as j_make_drift
from repro.serve import ChordsEngine as JChordsEngine
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.ode import uniform_tgrid
from repro_torch.diffusion import init_wrapper, make_drift
from repro_torch.serve import ChordsEngine, ContinuousEngine, Request
from repro_torch.utils.convert import load_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, S, LATENT = 12, 4, 2, 8
# (priority, rtol, deadline_rounds) per request: early accepts, a forced
# full-N solve (rtol 0), priorities that pick other init sequences and
# deadlines; LATE arrives after 3 steps with a deadline that edf-preempt
# meets only by evicting a lane
REQS = [(0, None, None), (1, 0.5, 20), (0, 0.0, None), (2, None, 14),
        (0, 0.3, 30)]
LATE = (9, 0, None, 10)  # rid, priority, rtol, deadline_rounds


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("chords-dit-xl", reduced=True)
    tcfg = get_config("chords-dit-xl", reduced=True)
    params = j_init_wrapper(jcfg, LATENT, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(
        init_wrapper(tcfg, LATENT, device="cpu"),
        jax.tree_util.tree_map(lambda a: np.array(a), params))
    return (j_make_drift(params, jcfg), make_drift(tparams, tcfg))


def _noise(i, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(100 + i), shape))


def _drive(eng, make_request):
    for i, (prio, rtol, dl) in enumerate(REQS):
        eng.submit(make_request(i, prio, rtol, dl))
    done = []
    for _ in range(3):
        done += eng.step()
    rid, prio, rtol, dl = LATE
    eng.submit(make_request(rid, prio, rtol, dl))
    done += eng.run_until_drained()
    return dict(done), eng.stats()


def _serve_jax(drift, policy):
    eng = JContinuousEngine(drift, (1, 16, LATENT), N, K, j_tgrid(N),
                            num_slots=S, policy=policy)
    return _drive(eng, lambda i, prio, rtol, dl: JRequest(
        rid=i, key=jax.random.PRNGKey(100 + i), priority=prio, rtol=rtol,
        deadline_rounds=dl))


def _serve_port(drift, policy, use_kernel):
    eng = ContinuousEngine(drift, (1, 16, LATENT), N, K, uniform_tgrid(N),
                           num_slots=S, policy=policy, use_kernel=use_kernel,
                           device="cpu")
    with torch.no_grad():
        return _drive(eng, lambda i, prio, rtol, dl: Request(
            rid=i, x0=_noise(i, (1, 16, LATENT)), priority=prio, rtol=rtol,
            deadline_rounds=dl))


@pytest.mark.parametrize("policy", ["fifo", "edf", "edf-preempt"])
def test_continuous_engine_matches_jax(models, policy):
    jdrift, tdrift = models
    out_j, st_j = _serve_jax(jdrift, policy)
    out_t, st_t = _serve_port(tdrift, policy, use_kernel=True)
    assert sorted(out_j) == sorted(out_t) == \
        list(range(len(REQS))) + [LATE[0]]
    if policy == "edf-preempt":
        assert st_j["preemptions"] >= 1  # the trace exercises eviction
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core, b.latency_rounds) == \
            (a.rounds_used, a.accepted_core, a.latency_rounds), rid
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    for key in ("served", "rounds_total", "host_syncs", "retraces",
                "preemptions", "deadline_misses", "deadline_total",
                "wasted_slot_rounds", "dispatches"):
        assert st_t[key] == st_j[key], key
    assert set(st_t) == set(st_j)
    assert st_t["kernel_path"] == "fused-accept-ref"


def test_continuous_use_kernel_flip_is_bitwise(models):
    _, tdrift = models
    out_k, st_k = _serve_port(tdrift, "edf", use_kernel=True)
    out_p, st_p = _serve_port(tdrift, "edf", use_kernel=False)
    for rid in out_k:
        assert torch.equal(out_k[rid].sample, out_p[rid].sample)
        assert out_k[rid].rounds_used == out_p[rid].rounds_used
    assert st_p["kernel_path"] == "torch-unfused"


def _static(engine_cls, req_cls, drift, tgrid, noise_kw, **kw):
    eng = engine_cls(drift, (16, LATENT), N, K, tgrid, max_batch=S, **kw)
    for i in range(3):
        eng.submit(req_cls(rid=i, **noise_kw(i)))
    done = []
    with torch.no_grad():
        while eng.queue:
            done += eng.step()
    return dict(done), eng


@pytest.mark.parametrize("rtol", [0.05, 0.5])
def test_chords_engine_matches_jax(models, rtol):
    jdrift, tdrift = models
    out_j, ej = _static(JChordsEngine, JRequest, jdrift, j_tgrid(N),
                        lambda i: {"key": jax.random.PRNGKey(100 + i)},
                        rtol=rtol)
    out_t, et = _static(ChordsEngine, Request, tdrift, uniform_tgrid(N),
                        lambda i: {"x0": _noise(i, (16, LATENT))},
                        rtol=rtol, use_kernel=True, device="cpu")
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core) == (a.rounds_used,
                                                    a.accepted_core)
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    assert et.total_rounds() == ej.total_rounds()
    assert et.executor.stream_traces == 1


def test_chords_engine_use_kernel_flip_is_bitwise(models):
    _, tdrift = models
    runs = [_static(ChordsEngine, Request, tdrift, uniform_tgrid(N),
                    lambda i: {"seed": i}, use_kernel=uk, device="cpu")[0]
            for uk in (True, False)]
    for rid in runs[0]:
        assert torch.equal(runs[0][rid].sample, runs[1][rid].sample)


@pytest.mark.parametrize("kw", [{"overlap": True}, {"min_slots": 1},
                                {"lane_profile": True}])
def test_unported_engine_features_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ContinuousEngine(lambda x, t: -x, (2,), 4, 2, uniform_tgrid(4),
                         num_slots=2, device="cpu", **kw)


@pytest.mark.parametrize("extra,expect", [
    ((), "served=8"),
    (("--static", "--use-kernels", "--requests", "5"),
     "static: served 5 requests"),
])
def test_launcher_runs_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", *extra], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout


@pytest.mark.parametrize("rtol", [0.05, 1e-3, 1e-4])  # accept: 24, 31, 38
def test_streaming_sampler_matches_jax(rtol):
    """The unbatched streaming sampler on the quickstart's Gaussian mixture:
    accepted round and core exact, sample within 1e-5."""
    from repro.core.ode import GaussianMixture as JGaussianMixture
    from repro.serve import StreamingSampler as JStreamingSampler
    from repro_torch.core.ode import GaussianMixture
    from repro_torch.serve import StreamingSampler
    gm = JGaussianMixture.random(jax.random.PRNGKey(0), num_modes=6, dim=16)
    gt = GaussianMixture(*(torch.from_numpy(np.array(a))
                           for a in (gm.mus, gm.sigmas, gm.weights)))
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 16)))
    a = JStreamingSampler(gm.drift, 50, 8, j_tgrid(50, 0.98),
                          rtol=rtol).sample(jnp.asarray(x0))
    b = StreamingSampler(gt.drift, 50, 8, uniform_tgrid(50, 0.98), rtol=rtol,
                         device="cpu").sample(torch.from_numpy(x0))
    assert (b.rounds_used, b.accepted_core) == (a.rounds_used,
                                                a.accepted_core)
    np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                               atol=1e-5)
