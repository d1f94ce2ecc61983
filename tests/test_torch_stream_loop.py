"""The batch stream program (``StreamingSampler``, ``ChordsEngine``) as one
device loop, against the JAX package's ``_build_stream_fn`` while_loop, on
the CPU.

The port keeps the JAX loop's structure: the round counter is a device
tensor, the emitting core a gather from a static table (-1 where no core
emits), ``has_last`` a device flag, acceptance gated as in JAX, and the
exit ``~all(accepted) & r <= N`` is the device loop's condition on
``~accepted`` with budget N. On the card the same program is one CUDA
graph (``tests/test_torch_kernels_gpu.py`` holds it to this eager one
bitwise).

Exact: rounds, chosen core, which requests fell through, rounds the loop
ran, host readbacks a call (1). Samples: within the drifts' CPU contracts
against the JAX package (1e-5 on the closed-form Gaussian mixture, 1e-4
through the micro DiT, as ``tests/test_torch_serve.py``: torch and XLA
evaluate the drift in other orders); bitwise inside the port (the
``use_kernel`` flip, the program against a host-driven reference loop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import scheduler as jsched
from repro.core.ode import GaussianMixture as JGaussianMixture
from repro.core.ode import uniform_tgrid as j_tgrid
from repro.diffusion import init_wrapper as j_init_wrapper
from repro.diffusion import make_drift as j_make_drift
from repro.serve import ChordsEngine as JChordsEngine
from repro.serve import Request as JRequest
from repro.serve import StreamingSampler as JStreamingSampler
from repro_torch.configs import get_config
from repro_torch.core.init_sequence import make_sequence
from repro_torch.core.ode import GaussianMixture, uniform_tgrid
from repro_torch.diffusion import init_wrapper, make_drift
from repro_torch.serve import ChordsEngine, Request, StreamingSampler
from repro_torch.serve.executor import (EagerStream, StreamSpec,
                                        _stream_fns, emit_core_table)
from repro_torch.utils.convert import load_jax_params

N, K = 50, 8


def _gm():
    gm = JGaussianMixture.random(jax.random.PRNGKey(0), num_modes=6, dim=16)
    gt = GaussianMixture(*(torch.from_numpy(np.array(a))
                           for a in (gm.mus, gm.sigmas, gm.weights)))
    return gm.drift, gt.drift


@pytest.fixture(scope="module")
def dit():
    lat = 8
    jcfg = j_get_config("chords-dit-xl", reduced=True)
    tcfg = get_config("chords-dit-xl", reduced=True)
    params = j_init_wrapper(jcfg, lat, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(jcfg.d_model)
    tparams = load_jax_params(
        init_wrapper(tcfg, lat, device="cpu"),
        jax.tree_util.tree_map(lambda a: np.array(a), params))
    return j_make_drift(params, jcfg), make_drift(tparams, tcfg), tcfg


def _fell_through(tdrift, n, k, rtol, batched, x0, live):
    """Run the port's program pieces by hand: (fell_through, rounds the
    loop ran), read from the loop state before the fall-through step."""
    tg = uniform_tgrid(n, 0.98)
    fns = _stream_fns(tdrift, tg, n, StreamSpec(
        num_cores=k, i_seq=tuple(make_sequence(k, n)), rtol=rtol,
        batched=batched), use_kernel=True)
    st = fns["init"](x0, live)
    ran = 0
    while bool(st.pending.any()) and int(st.r) <= n:
        st = fns["body"](st)
        ran += 1
    return (live & (st.rounds == 0)).numpy(), ran


def test_emit_core_table_is_the_argmax():
    for k, n in ((8, 50), (4, 12), (2, 10), (1, 5)):
        i_seq = make_sequence(k, n)
        emit = np.asarray(jsched.emit_rounds(list(i_seq), n))
        table = emit_core_table(i_seq, n)
        for r in range(n + 2):
            hit = emit == r
            assert table[r] == (int(np.argmax(hit)) if hit.any() else -1)


@pytest.mark.parametrize("rtol", [0.0, 0.05, 1e-9, 1e-3])
def test_unbatched_sampler_matches_jax(rtol):
    jdrift, tdrift = _gm()
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 16)))
    a = JStreamingSampler(jdrift, N, K, j_tgrid(N, 0.98),
                          rtol=rtol).sample(jnp.asarray(x0))
    s = StreamingSampler(tdrift, N, K, uniform_tgrid(N, 0.98), rtol=rtol,
                         device="cpu")
    with torch.no_grad():
        b = s.sample(torch.from_numpy(x0))
    assert (b.rounds_used, b.accepted_core) == (a.rounds_used,
                                                a.accepted_core)
    np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                               atol=1e-5)
    assert s.host_readbacks == 1
    assert isinstance(s.program, EagerStream)
    ft, ran = _fell_through(tdrift, N, K, rtol, False,
                            torch.from_numpy(x0), torch.ones((), dtype=bool))
    if rtol == 0.0:
        assert bool(ft)
    if bool(ft):  # fell through: never accepted, the final emission at N
        assert a.rounds_used == N
    assert s.program.rounds_run == ran
    assert ran == (N if bool(ft) else a.rounds_used)


@pytest.mark.parametrize("rtol", [0.0, 0.05, 1e-9])
def test_batched_sampler_with_padding_matches_jax(rtol):
    jdrift, tdrift = _gm()
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(5), (5, 4, 16)))
    live = np.array([True, True, False, True, True])
    a = JStreamingSampler(jdrift, N, K, j_tgrid(N, 0.98), rtol=rtol,
                          batched=True).sample(jnp.asarray(x0),
                                               live=jnp.asarray(live))
    s = StreamingSampler(tdrift, N, K, uniform_tgrid(N, 0.98), rtol=rtol,
                         batched=True, device="cpu")
    with torch.no_grad():
        b = s.sample(torch.from_numpy(x0), live=torch.from_numpy(live))
    np.testing.assert_array_equal(b.rounds_used, np.asarray(a.rounds_used))
    np.testing.assert_array_equal(b.accepted_core,
                                  np.asarray(a.accepted_core))
    np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                               atol=1e-5)
    ft, ran = _fell_through(tdrift, N, K, rtol, True,
                            torch.from_numpy(x0), torch.from_numpy(live))
    # fell through: never accepted, so the final emission at round N
    rounds_j = np.asarray(a.rounds_used)
    assert not (ft & ~(live & (rounds_j == N))).any()
    if rtol == 0.0:
        np.testing.assert_array_equal(ft, live)
    assert ran == int(np.asarray(a.rounds_used)[live].max())
    assert s.program.rounds_run == ran and s.host_readbacks == 1


@pytest.mark.parametrize("rtol", [0.0, 0.05, 1e-9])
def test_chords_engine_on_the_micro_dit_matches_jax(dit, rtol):
    jdrift, tdrift, _ = dit
    n, k, lat = 12, 4, (16, 8)

    def serve(cls, req, tg, noise, **kw):
        eng = cls(jdrift if cls is JChordsEngine else tdrift, lat, n, k, tg,
                  max_batch=4, rtol=rtol, **kw)
        for i in range(3):
            eng.submit(req(rid=i, **noise(i)))
        done = []
        with torch.no_grad():
            while eng.queue:
                done += eng.step()
        return dict(done), eng

    out_j, ej = serve(JChordsEngine, JRequest, j_tgrid(n),
                      lambda i: {"key": jax.random.PRNGKey(100 + i)})
    out_t, et = serve(ChordsEngine, Request, uniform_tgrid(n),
                      lambda i: {"x0": np.array(jax.random.normal(
                          jax.random.PRNGKey(100 + i), lat))},
                      use_kernel=True, device="cpu")
    for rid in out_j:
        a, b = out_j[rid], out_t[rid]
        assert (b.rounds_used, b.accepted_core) == (a.rounds_used,
                                                    a.accepted_core)
        np.testing.assert_allclose(b.sample.numpy(), np.asarray(a.sample),
                                   atol=1e-4)
    assert et.total_rounds() == ej.total_rounds()
    assert et.sampler.host_readbacks == len(et.stats) == 1
    assert et.executor.stream_traces == 1


def test_use_kernel_flip_and_host_loop_are_bitwise(dit):
    """The program is bitwise the same with the kernels' plain versions,
    and bitwise a host-driven loop over the same round body (the shape of
    the program before it ran on the device)."""
    _, tdrift, _ = dit
    n, k = 12, 4
    x0 = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(9), (3, 16, 8))))
    live = torch.tensor([True, False, True])
    outs = []
    for uk in (True, False):
        s = StreamingSampler(tdrift, n, k, uniform_tgrid(n), rtol=0.05,
                             batched=True, use_kernel=uk, device="cpu")
        with torch.no_grad():
            outs.append(s.sample(x0, live=live))
    assert torch.equal(outs[0].sample, outs[1].sample)
    np.testing.assert_array_equal(outs[0].rounds_used, outs[1].rounds_used)
    fns = _stream_fns(tdrift, uniform_tgrid(n), n, StreamSpec(
        num_cores=k, i_seq=tuple(make_sequence(k, n)), rtol=0.05,
        batched=True), use_kernel=True)
    with torch.no_grad():
        st = fns["init"](x0, live)
        for _ in range(n):  # every round: rounds after the exit change
            st = fns["body"](st)  # nothing accepted (gated by ~accepted)
        res, rc = fns["finish"](st, live)
    assert torch.equal(res, outs[0].sample)
    np.testing.assert_array_equal(rc[0].numpy(), outs[0].rounds_used)
    assert st.r.dtype == torch.int32 and st.r.ndim == 0
