"""The hybrid denoiser slice, JAX package vs port (CPU): the SSD chunk
block, the Mamba2 layer in both arrangements, the ``zamba2-2.7b`` (reduced)
denoiser and the serving engines over it. Inputs are numpy arrays handed to
both packages; parameters are the reference's, loaded with
``load_jax_params``.

Tolerances: ``ssd_chunk`` 1e-4 (``tests/test_kernels.py``); the Mamba2 layer
and the f32 denoiser 2e-5, over a 16-token sequence in chunks of 8, so that
two chunks run the inter-chunk recurrence; the bf16 denoiser by relative L2
error <= 2e-2 (the JAX package's own bf16 kernels-vs-plain figure on the
same inputs is ~6.5e-3, and the elementwise bf16 contract does not hold for
the hybrid even between the reference's two paths); serving: scheduling and
the ``stats()`` counts exact, samples 1e-4.
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

from repro.configs import get_config as j_get_config
from repro.core.ode import uniform_tgrid as j_tgrid
from repro.diffusion import denoise as j_denoise
from repro.diffusion import init_wrapper as j_init_wrapper
from repro.diffusion import make_drift as j_make_drift
from repro.kernels.ssd_scan.kernel import ssd_chunk as j_ssd_chunk
from repro.models import mamba2 as jM
from repro.serve import ChordsEngine as JChordsEngine
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.ode import uniform_tgrid
from repro_torch.diffusion import denoise, init_wrapper, make_drift
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_batched_ref,
                                              ssd_chunk_ref)
from repro_torch.models import mamba2 as M
from repro_torch.serve import ChordsEngine, ContinuousEngine, Request
from repro_torch.utils.convert import load_jax_params, to_numpy, to_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, LATENT, SEQ = "zamba2-2.7b", 8, 16


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _models(compute_dtype="float32"):
    """The reference's reduced hybrid wrapper and the port's copy of it.
    out_proj is drawn at fan-in scale (its zero init would make the drift
    vanish)."""
    jcfg = j_get_config(ARCH, reduced=True).replace(
        compute_dtype=compute_dtype)
    tcfg = get_config(ARCH, reduced=True).replace(compute_dtype=compute_dtype)
    params = dict(j_init_wrapper(jcfg, LATENT, jax.random.PRNGKey(2)))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    np_params = jax.tree_util.tree_map(np.array, params)
    tparams = load_jax_params(init_wrapper(tcfg, LATENT, device="cpu"),
                              np_params)
    return jcfg, params, np_params, tcfg, tparams


@pytest.fixture(scope="module")
def hybrid():
    return _models()


def _x(batch=2):
    return np.array(jax.random.normal(jax.random.PRNGKey(4),
                                      (batch, SEQ, LATENT)))


# --- the SSD chunk block ------------------------------------------------------

@pytest.mark.parametrize("g,h,lc,n,hd", [(2, 2, 16, 8, 8), (1, 4, 32, 16, 16),
                                         (3, 1, 64, 32, 8)])
def test_ssd_chunk_ref_matches_pallas_interpret(g, h, lc, n, hd):
    rng = np.random.default_rng(lc + n)
    c = rng.standard_normal((g, lc, n)).astype(np.float32)
    b = rng.standard_normal((g, lc, n)).astype(np.float32)
    xdt = rng.standard_normal((g, h, lc, hd)).astype(np.float32)
    cum = -np.abs(rng.standard_normal((g, h, lc))).cumsum(-1) \
        .astype(np.float32)
    yj, sj = (np.asarray(a) for a in j_ssd_chunk(
        *(jnp.asarray(a) for a in (c, b, xdt, cum))))
    tc, tb, tx, tu = (to_torch(a) for a in (c, b, xdt, cum))
    y, s = ssd_chunk_batched_ref(tc, tb, tx, tu)
    np.testing.assert_allclose(y.numpy(), yj, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), sj, atol=1e-4)
    for gi in range(g):
        for hi in range(h):
            y1, s1 = ssd_chunk_ref(tc[gi], tb[gi], tx[gi, hi], tu[gi, hi])
            np.testing.assert_allclose(y1.numpy(), yj[gi, hi], atol=1e-4)
            np.testing.assert_allclose(s1.numpy(), sj[gi, hi], atol=1e-4)
    # on CPU tensors the dispatcher runs the plain version
    yo, so = ssd_ops.ssd_chunk(tc, tb, tx, tu, use_kernel=True)
    assert torch.equal(yo, y) and torch.equal(so, s)


# --- the Mamba2 layer ---------------------------------------------------------

@pytest.mark.parametrize("arrangement", ["chunked", "plain"])
def test_ssd_forward_matches_jax(hybrid, arrangement):
    """The port's kernel arrangement (run with the plain chunk function)
    against the reference's under ``use_kernels="interpret"`` (the Pallas
    kernel interpreted), and the plain body against the reference's plain
    scan; from a nonzero conv and SSM state, over two chunks."""
    jcfg, _, np_params, tcfg, _ = hybrid
    p0 = {k: v[0] for k, v in
          np_params["backbone"]["mamba"]["ssd"].items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, SEQ, jcfg.d_model)).astype(np.float32)
    din, n = jM.d_inner(jcfg), jcfg.ssm_state
    conv0 = 0.5 * rng.standard_normal(
        (2, jcfg.ssm_conv - 1, din + 2 * n)).astype(np.float32)
    ssm0 = 0.5 * rng.standard_normal(
        (2, jM.num_ssm_heads(jcfg), jcfg.ssm_head_dim, n)).astype(np.float32)
    assert SEQ // min(jcfg.ssm_chunk, SEQ) == 2
    kernels = "interpret" if arrangement == "chunked" else False
    yj, (cj, sj) = jM.ssd_forward(
        jax.tree_util.tree_map(jnp.asarray, p0),
        jcfg.replace(use_kernels=kernels),
        *(jnp.asarray(a) for a in (x, conv0, ssm0)))
    chunk_fn = ssd_chunk_batched_ref if arrangement == "chunked" else None
    y, (c, s) = M.ssd_forward({k: to_torch(v) for k, v in p0.items()}, tcfg,
                              *(to_torch(a) for a in (x, conv0, ssm0)),
                              chunk_fn=chunk_fn)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=2e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))


def test_ssd_arrangements_agree_on_cpu(hybrid):
    """Inside the port, the kernel arrangement with the plain chunk
    function and the plain scan body compute the same layer."""
    _, _, np_params, tcfg, _ = hybrid
    p0 = {k: to_torch(v[0]) for k, v in
          np_params["backbone"]["mamba"]["ssd"].items()}
    x = to_torch(np.random.default_rng(8).standard_normal(
        (3, 4 * tcfg.ssm_chunk, tcfg.d_model)).astype(np.float32))
    a, (_, sa) = M.ssd_forward(p0, tcfg, x,
                               chunk_fn=ssd_chunk_batched_ref)
    b, (_, sb) = M.ssd_forward(p0, tcfg, x)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    torch.testing.assert_close(sa, sb, atol=2e-5, rtol=0)


# --- the denoiser -------------------------------------------------------------

def test_hybrid_denoise_matches_jax_f32(hybrid):
    jcfg, params, _, tcfg, tparams = hybrid
    x = _x()
    ref = np.asarray(j_denoise(params, jcfg, jnp.asarray(x), 0.35))
    out = denoise(tparams, tcfg, to_torch(x), 0.35).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_hybrid_denoise_matches_jax_bf16():
    jcfg, params, _, tcfg, tparams = _models("bfloat16")
    x = _x()
    ref = np.asarray(j_denoise(params, jcfg, jnp.asarray(x), 0.35),
                     np.float32)
    jax_k = np.asarray(j_denoise(params, jcfg.replace(use_kernels="interpret"),
                                 jnp.asarray(x), 0.35), np.float32)
    out = to_numpy(denoise(tparams, tcfg, to_torch(x), 0.35))
    port_err, jax_err = _rel_l2(out, ref), _rel_l2(jax_k, ref)
    assert port_err <= 2e-2, (port_err, jax_err)


def test_hybrid_use_kernels_flip_is_bitwise_on_cpu(hybrid):
    _, _, _, tcfg, tparams = hybrid
    x = to_torch(_x())
    a = denoise(tparams, tcfg, x, 0.35)
    b = denoise(tparams, tcfg.replace(use_kernels=True), x, 0.35)
    assert torch.equal(a, b)
    # causal whatever the caller asks: the trunk refuses causal=False
    from repro_torch.models import zamba2
    with pytest.raises(ValueError, match="causal-only"):
        zamba2.forward_hidden(tparams["backbone"], tcfg,
                              torch.zeros(1, SEQ, tcfg.d_model), causal=False)


def test_load_jax_params_hybrid(hybrid):
    jcfg, _, np_params, _, tparams = hybrid
    flat = {k: to_numpy(v) for k, v in tparams.named_parameters()}
    assert "backbone.embed.tok" in flat  # unused by the denoiser, loaded
    for name, arr in (("backbone.embed.tok",
                       np_params["backbone"]["embed"]["tok"]),
                      ("backbone.mamba.ssd.in_proj",
                       np_params["backbone"]["mamba"]["ssd"]["in_proj"]),
                      ("backbone.shared.ln_in",
                       np_params["backbone"]["shared"]["ln_in"])):
        np.testing.assert_array_equal(flat[name], arr)
    assert flat["backbone.mamba.ssd.conv_w"].shape[0] == jcfg.num_layers
    assert flat["backbone.shared.w_in"].shape == (2 * jcfg.d_model,
                                                  jcfg.d_model)


# --- serving ------------------------------------------------------------------

N, K, S = 8, 4, 2
# (priority, rtol, deadline_rounds): early accepts, a forced full-N solve,
# deadlines; LATE arrives after 2 steps with a deadline that edf-preempt
# meets only by evicting a lane
REQS = [(0, None, None), (1, 0.5, 12), (0, 0.0, None), (2, None, 9)]
LATE = (9, 0, None, 6)  # rid, priority, rtol, deadline_rounds


@pytest.fixture(scope="module")
def drifts(hybrid):
    jcfg, params, _, tcfg, tparams = hybrid
    return j_make_drift(params, jcfg), make_drift(tparams, tcfg)


def _noise(i, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(100 + i), shape))


def _drive(eng, make_request):
    for i, (prio, rtol, dl) in enumerate(REQS):
        eng.submit(make_request(i, prio, rtol, dl))
    done = []
    for _ in range(2):
        done += eng.step()
    rid, prio, rtol, dl = LATE
    eng.submit(make_request(rid, prio, rtol, dl))
    done += eng.run_until_drained()
    return dict(done), eng.stats()


@pytest.mark.parametrize("policy", ["fifo", "edf", "edf-preempt"])
def test_continuous_engine_hybrid_matches_jax(drifts, policy):
    jdrift, tdrift = drifts
    shape = (1, SEQ, LATENT)
    out_j, st_j = _drive(
        JContinuousEngine(jdrift, shape, N, K, j_tgrid(N), num_slots=S,
                          policy=policy),
        lambda i, prio, rtol, dl: JRequest(
            rid=i, key=jax.random.PRNGKey(100 + i), priority=prio,
            rtol=rtol, deadline_rounds=dl))
    with torch.no_grad():
        out_t, st_t = _drive(
            ContinuousEngine(tdrift, shape, N, K, uniform_tgrid(N),
                             num_slots=S, policy=policy, use_kernel=True,
                             device="cpu"),
            lambda i, prio, rtol, dl: Request(
                rid=i, x0=_noise(i, shape), priority=prio, rtol=rtol,
                deadline_rounds=dl))
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
    assert st_t["kernel_path"] == "fused-accept-ref"


def test_chords_engine_hybrid_matches_jax(drifts):
    jdrift, tdrift = drifts
    shape = (SEQ, LATENT)
    ej = JChordsEngine(jdrift, shape, N, K, j_tgrid(N), max_batch=S)
    et = ChordsEngine(tdrift, shape, N, K, uniform_tgrid(N), max_batch=S,
                      use_kernel=True, device="cpu")
    for i in range(3):
        ej.submit(JRequest(rid=i, key=jax.random.PRNGKey(100 + i)))
        et.submit(Request(rid=i, x0=_noise(i, shape)))
    out_j, out_t = [], []
    while ej.queue:
        out_j += ej.step()
    with torch.no_grad():
        while et.queue:
            out_t += et.step()
    out_j, out_t = dict(out_j), dict(out_t)
    assert sorted(out_t) == sorted(out_j) == [0, 1, 2]
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core) == (a.rounds_used,
                                                    a.accepted_core)
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    assert et.total_rounds() == ej.total_rounds()


@pytest.mark.parametrize("extra,expect", [
    (("--requests", "4"), "served=4"),
    (("--static", "--use-kernels", "--requests", "3"),
     "static: served 3 requests"),
])
def test_launcher_serves_hybrid_on_cpu(extra, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "12", "--seq", "16",
         *extra], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout
