"""The paper's baselines (ParaDiGMS, SRDS), Heun and the reward surrogate in
the port against the JAX package, on the CPU.

Tolerances: rounds and iterations exactly (they are host decisions);
outputs within 1e-6 relative (``atol = 1e-6 * max|ref|``) on the
closed-form Gaussian-mixture drift, whose torch and XLA evaluations differ
in the last ulps, and within 1e-4 absolute through the micro DiT (the
drift's f32 contract of 2e-5 a call, ``tests/test_torch_model.py``, over a
dozen sequential calls). Heun within 1e-6 relative. ``reward`` and
``speedup_cont`` are pure Python copies: bitwise.

Each decision of a baseline compares an f32 relative error with ``tol``;
both packages' errors are recorded (by wrapping ``_rel_err`` in each
module for the test) and the smallest margin ``|err - tol| / tol`` is
printed, so that a flip at the border shows itself as one.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import baselines as jbase
from repro.core import solvers as jsolvers
from repro.core.init_sequence import theorem_sequence
from repro.core.ode import GaussianMixture as JGaussianMixture
from repro.core.ode import uniform_tgrid as j_tgrid
from repro.diffusion import init_wrapper as j_init_wrapper
from repro.diffusion import make_drift as j_make_drift
from repro_torch.configs import get_config
from repro_torch.core import baselines as tbase
from repro_torch.core import solvers as tsolvers
from repro_torch.core.ode import GaussianMixture, uniform_tgrid
from repro_torch.diffusion import init_wrapper, make_drift
from repro_torch.utils.convert import load_jax_params


# the modules (each package's core exports the function under the same name)
jreward = importlib.import_module("repro.core.reward")
treward = importlib.import_module("repro_torch.core.reward")


def _gm_pair():
    gm = JGaussianMixture.random(jax.random.PRNGKey(0), num_modes=4, dim=8)
    gt = GaussianMixture(*(torch.from_numpy(np.array(a))
                           for a in (gm.mus, gm.sigmas, gm.weights)))
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 8)))
    return gm.drift, gt.drift, x0


def _dit_pair(latent=8, seq=8):
    jcfg = j_get_config("chords-dit-xl", reduced=True)
    tcfg = get_config("chords-dit-xl", reduced=True)
    params = j_init_wrapper(jcfg, latent, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(
        init_wrapper(tcfg, latent, device="cpu"),
        jax.tree_util.tree_map(lambda a: np.array(a), params))
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(4), (2, seq, latent)))
    return j_make_drift(params, jcfg), make_drift(tparams, tcfg), x0


DRIFTS = {"gmm": (_gm_pair, 1e-6, None), "dit": (_dit_pair, None, 1e-4)}


def _close(out, ref, rel, atol):
    ref = np.asarray(ref)
    tol = atol if atol is not None else rel * float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


@pytest.fixture
def record(monkeypatch):
    """Wrap both packages' ``_rel_err`` to record every error a decision
    reads; returns {"jax": [...], "port": [...]}."""
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jbase._rel_err, tbase._rel_err

    def j_rec(new, old, eps=1e-12):
        out = j_orig(new, old, eps)
        seen["jax"] += [float(v) for v in np.asarray(out).ravel()]
        return out

    def t_rec(new, old, eps=1e-12):
        out = t_orig(new, old, eps)
        seen["port"] += [float(v) for v in out.reshape(-1)]
        return out

    monkeypatch.setattr(jbase, "_rel_err", j_rec)
    monkeypatch.setattr(tbase, "_rel_err", t_rec)
    return seen


def _margin(seen, tol, name):
    errs = np.array(seen["port"])
    assert len(errs) == len(seen["jax"])
    m = float(np.min(np.abs(errs - tol)) / tol)
    print(f"[{name}] {len(errs)} errors against tol {tol}: smallest margin "
          f"{m:.3e} of tol; max |port - jax| "
          f"{float(np.max(np.abs(errs - np.array(seen['jax'])))):.3e}")
    return m


@pytest.mark.parametrize("window,tol,n", [(8, 1e-4, 32), (4, 2e-3, 32),
                                          (8, 2e-3, 20)])
@pytest.mark.parametrize("which", sorted(DRIFTS))
def test_paradigms_matches_jax(record, which, window, tol, n):
    make, rel, atol = DRIFTS[which]
    if which == "dit":
        n = 12
    jdrift, tdrift, x0 = make()
    a = jbase.paradigms_sample(jdrift, jnp.asarray(x0), j_tgrid(n, 0.98),
                               window=window, tol=tol)
    b = tbase.paradigms_sample(tdrift, torch.from_numpy(x0),
                               uniform_tgrid(n, 0.98), window=window,
                               tol=tol, device="cpu")
    _margin(record, tol, f"paradigms {which} w={window}")
    assert (b.rounds, b.n_steps) == (a.rounds, a.n_steps)
    assert b.speedup == a.speedup
    _close(b.output.numpy(), a.output, rel, atol)


# the micro DiT runs short grids: the JAX SRDS compiles one solver a segment
@pytest.mark.parametrize("which,segments,tol,max_iters,n", [
    ("gmm", 4, 1e-6, 4, 24), ("gmm", 4, 5e-2, None, 24),
    ("gmm", 5, 1e-3, None, 50), ("gmm", 3, 1e-7, None, 10),
    ("dit", 3, 1e-7, None, 10), ("dit", 4, 5e-2, 2, 12)])
def test_srds_matches_jax(record, which, segments, tol, max_iters, n):
    make, rel, atol = DRIFTS[which]
    jdrift, tdrift, x0 = make()
    a = jbase.srds_sample(jdrift, jnp.asarray(x0), j_tgrid(n, 0.98),
                          num_segments=segments, tol=tol, max_iters=max_iters)
    b = tbase.srds_sample(tdrift, torch.from_numpy(x0),
                          uniform_tgrid(n, 0.98), num_segments=segments,
                          tol=tol, max_iters=max_iters, device="cpu")
    _margin(record, tol, f"srds {which} m={segments}")
    assert (b.rounds, b.iters, b.n_steps) == (a.rounds, a.iters, a.n_steps)
    _close(b.output.numpy(), a.output, rel, atol)


def test_srds_bounds_round_half_to_even():
    """n = 10 over 4 segments hits 2.5 and 7.5: Python's round gives 2 and
    8, so the segments are 2, 3, 3, 2 long in both packages."""
    _, tdrift, x0 = _gm_pair()
    b = tbase.srds_sample(tdrift, torch.from_numpy(x0), uniform_tgrid(10, 0.98),
                          num_segments=4, tol=0.0, max_iters=1, device="cpu")
    assert b.rounds == 4 + 3 + 4  # init sweep, longest segment, correction


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_sequential_heun_matches_jax(method):
    jdrift, tdrift, x0 = _gm_pair()
    a = jsolvers.sequential_sample(jdrift, jnp.asarray(x0), j_tgrid(50, 0.98),
                                   method=method)
    b, traj = tsolvers.sequential_sample(tdrift, torch.from_numpy(x0),
                                         uniform_tgrid(50, 0.98),
                                         method=method, collect=True,
                                         device="cpu")
    _close(b.numpy(), a, 1e-6, None)
    assert traj.shape == (50,) + x0.shape
    assert tsolvers.nfe_per_step(method) == jsolvers.nfe_per_step(method)


def test_heun_is_second_order():
    """Heun's error against a fine solve falls ~4x when N doubles (Euler's
    ~2x), on the closed-form drift."""
    _, tdrift, x0 = _gm_pair()
    x0 = torch.from_numpy(x0)
    ref = tsolvers.sequential_sample(tdrift, x0, uniform_tgrid(800, 0.9),
                                     method="heun", device="cpu")
    errs = [float((tsolvers.sequential_sample(
        tdrift, x0, uniform_tgrid(n, 0.9), method="heun", device="cpu")
        - ref).abs().max()) for n in (25, 50)]
    assert errs[0] / errs[1] > 3.0, errs


REWARD_SEQS = ([[0.0], [0.0, 0.5], [0.0, 0.25, 0.5], [0.0, 0.2, 0.4, 0.7]]
               + [[0.0, float(t2), 0.75] for t2 in np.linspace(0.02, 0.73, 40)]
               + [[0.0, m * t, t] for t in (0.2, 0.4, 0.6, 0.9)
                  for m in (0.3, 0.5, 0.7)]
               + [[0.0, t / 2, t] for t in np.linspace(0.1, 0.6, 11)]
               + [list(theorem_sequence(4, 10 / 3)),
                  list(theorem_sequence(8, 2.9))])


def test_reward_and_speedup_bitwise():
    for seq in REWARD_SEQS:
        assert treward.reward(seq) == jreward.reward(seq), seq
        if len(seq) > 1:
            assert treward.speedup_cont(seq) == jreward.speedup_cont(seq)
    with pytest.raises(ValueError):
        treward.reward([0.0, 0.5, 0.4])
