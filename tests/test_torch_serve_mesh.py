"""CHORDS serving on a device mesh: the port on four gloo ranks of the CPU
against the JAX package on four fake CPU devices, both on a
``(data 2, model 2)`` mesh under ``SERVE_RULES``.

One module fixture runs both sides once, at the same time, in
subprocesses: ``test_torch_mesh_ranks.py``'s job ``serve`` (the port, which
also serves every request on one device for comparison) and
:func:`_jax_side` (the reference). Both read the same inputs: the reduced
``chords-dit-xl`` wrapper's parameters from the JAX package, and the
reference's ``jax.random`` noise of each request (injected into the port
through ``Request.x0``). The trace is ``test_torch_serve.py``'s (S 2, K 4,
N 12, five requests and a late one).

- ``ContinuousEngine`` under ``use_sharding`` (fifo and edf-preempt, one
  round a step; edf with up to 8 rounds a device program): scheduling
  exact against the reference and the one-device port (rounds, accepted
  core, latency, the ``stats()`` counts), samples within 1e-4 of the
  reference and 1e-5 relative of the one-device port.
- The slot grid's latents stay DTensors of local shape ``[S/2, K, ...]``,
  and no collective over ``data`` carries more than the [S] flags: the
  drained results are the only latents that cross ranks.
- ``ambient_sharding_tag()`` is the reference's string; an executor asked
  for one grid by a bare and by a mesh engine builds it twice.
- ``make_slot_round_body`` on DTensor state against the reference's jitted
  under ``use_sharding``.
- ``ChordsEngine`` (cores on ``data``, the rolls crossing ranks) against the
  reference and the one-device port; each round's wire carries one core's
  latent a rolled tensor and one for the emitted output, never the grid.
- Heterogeneous lanes, an elastic grid and the overlap loop on the mesh
  against one device.
- The step and accept kernels, ``ssd_chunk`` and the loop condition on
  DTensor operands (plain versions here) against the whole-tensor call.
- The reduced zamba2 hybrid denoiser served on the mesh against one
  device, and one SSD layer's kernel arrangement on a DTensor batch
  (``ssd_chunk`` on each rank's rows and heads) against the plain call.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.diffusion import init_wrapper as j_init_wrapper
from test_torch_mesh_ranks import (SERVE_K, SERVE_LATE, SERVE_LATENT,
                                   SERVE_N, SERVE_REQS, SERVE_RUNS, SERVE_S,
                                   SLOT_ROUNDS, start_jax, start_job,
                                   wait_all)

ROWS = SERVE_S * SERVE_K  # slot x core rows of a round's drift


def _jax_side(io_dir):
    """The reference on a (2, 2) mesh of fake devices (a subprocess)."""
    from repro.core.chords import ChordsCarry, make_slot_round_body
    from repro.core.ode import uniform_tgrid
    from repro.diffusion import make_drift
    from repro.diffusion.wrapper import wrapper_specs
    from repro.dist.sharding import SERVE_RULES, tree_shardings, use_sharding
    from repro.launch.mesh import make_mesh
    from repro.serve import ChordsEngine, ContinuousEngine, Request
    from repro.serve.executor import ambient_sharding_tag
    from repro.utils import pspec

    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = j_get_config("chords-dit-xl", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"))
    params = jax.tree_util.tree_map(jnp.asarray, inp["dit"])
    params = jax.device_put(params, tree_shardings(
        pspec.logical_axes(wrapper_specs(cfg, SERVE_LATENT)), mesh,
        SERVE_RULES, params))
    drift = make_drift(params, cfg)
    tg = uniform_tgrid(SERVE_N)
    out = {"engines": {}}

    def req(i, prio, rtol, dl):
        return Request(rid=i, key=jax.random.PRNGKey(100 + i), priority=prio,
                       rtol=rtol, deadline_rounds=dl)

    with use_sharding(mesh, SERVE_RULES):
        out["tag"] = ambient_sharding_tag()
        for policy, r_dev in SERVE_RUNS:
            eng = ContinuousEngine(drift, (1, 16, SERVE_LATENT), SERVE_N,
                                   SERVE_K, tg, num_slots=SERVE_S,
                                   policy=policy)
            for i, (prio, rtol, dl) in enumerate(SERVE_REQS):
                eng.submit(req(i, prio, rtol, dl))
            done = []
            for _ in range(3):
                done += eng.step(max_rounds_on_device=r_dev)
            eng.submit(req(*SERVE_LATE))
            done += eng.run_until_drained(max_rounds_on_device=r_dev)
            out["engines"][(policy, r_dev)] = (
                {rid: (np.asarray(o.sample), o.rounds_used, o.accepted_core,
                       o.latency_rounds) for rid, o in done}, eng.stats(),
                str(eng.state.carry.x.sharding.spec))
        body = jax.jit(make_slot_round_body(drift, tg, SERVE_N, SERVE_K))
        x0 = jnp.asarray(inp["slot_x0"])
        x = jnp.broadcast_to(x0[:, None], (x0.shape[0], SERVE_K)
                             + x0.shape[1:])
        carry = ChordsCarry(x, x, jnp.zeros_like(x),
                            jnp.asarray(inp["slot_iarr"]), jnp.zeros_like(x))
        live = jnp.ones(x0.shape[0], bool)
        for r in range(1, SLOT_ROUNDS + 1):
            carry, _ = body(carry, jnp.asarray(inp["slot_iarr"]),
                            jnp.full((x0.shape[0],), r, jnp.int32), live)
        out["slot_rounds"] = [np.asarray(t) for t in carry]
        ce = ChordsEngine(drift, (16, SERVE_LATENT), SERVE_N, SERVE_K, tg,
                          max_batch=SERVE_S)
        for i in range(3):
            ce.submit(Request(rid=i, key=jax.random.PRNGKey(200 + i)))
        done = []
        while ce.queue:
            done += ce.step()
        out["static"] = ({rid: (np.asarray(o.sample), o.rounds_used,
                                o.accepted_core) for rid, o in done},
                         ce.total_rounds())
    with open(os.path.join(io_dir, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)


def _inputs(io_dir):
    from repro.core.init_sequence import make_sequence

    cfg = j_get_config("chords-dit-xl", reduced=True)
    params = j_init_wrapper(cfg, SERVE_LATENT, jax.random.PRNGKey(2))
    params["out_proj"] = jax.random.normal(
        jax.random.PRNGKey(3), params["out_proj"].shape,
        jnp.float32) / np.sqrt(cfg.d_model)
    rids = list(range(len(SERVE_REQS))) + [SERVE_LATE[0]]
    noise = {i: np.array(jax.random.normal(jax.random.PRNGKey(100 + i),
                                           (1, 16, SERVE_LATENT)))
             for i in rids}
    static = {i: np.array(jax.random.normal(jax.random.PRNGKey(200 + i),
                                            (16, SERVE_LATENT)))
              for i in range(3)}
    seq = np.asarray(make_sequence(SERVE_K, SERVE_N), np.int32)
    inp = {"dit": jax.tree_util.tree_map(np.array, params), "noise": noise,
           "static_noise": static,
           "slot_x0": np.stack([noise[0], noise[1]]).astype(np.float32),
           "slot_iarr": np.stack([seq, seq])}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("serve_mesh"))
    _inputs(io_dir)
    wait_all(io_dir, [
        start_job("serve", io_dir),
        start_jax("from test_torch_serve_mesh import _jax_side; "
                  f"_jax_side({io_dir!r})", io_dir, devices=4)])
    with open(os.path.join(io_dir, "serve.pkl"), "rb") as f:
        port = pickle.load(f)
    with open(os.path.join(io_dir, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    return port, ref


def _same_schedule(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid][1:] == b[rid][1:], (rid, a[rid][1:], b[rid][1:])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


STAT_KEYS = ("served", "rounds_total", "host_syncs", "retraces",
             "preemptions", "deadline_misses", "deadline_total",
             "wasted_slot_rounds", "dispatches")


@pytest.mark.parametrize("run", SERVE_RUNS, ids=lambda r: f"{r[0]}-R{r[1]}")
def test_mesh_engine_matches_reference_and_one_device(runs, run):
    port, ref = runs
    got = port["engines"][run]
    (mesh_out, mesh_st), (one_out, one_st) = got["mesh"], got["one"]
    ref_out, ref_st, ref_spec = ref["engines"][run]
    assert sorted(mesh_out) == list(range(len(SERVE_REQS))) + [SERVE_LATE[0]]
    _same_schedule(mesh_out, ref_out)
    _same_schedule(mesh_out, one_out)
    for rid in mesh_out:
        np.testing.assert_allclose(mesh_out[rid][0], ref_out[rid][0],
                                   atol=1e-4)
        assert _rel(mesh_out[rid][0], one_out[rid][0]) < 1e-5, rid
    for key in STAT_KEYS:
        assert mesh_st[key] == ref_st[key] == one_st[key], key
    if run[1] > 1:  # the device loop ran several rounds a host sync
        assert mesh_st["host_syncs"] < mesh_st["rounds_total"]
    # the reference's slot grid also leads with slots on data
    assert ref_spec.startswith("PartitionSpec('data'")


def test_latents_stay_slot_sharded(runs):
    port, _ = runs
    for run in SERVE_RUNS:
        lay = port["engines"][run]["layout"]
        assert lay["kinds"] == ["DTensor"]
        assert lay["global"] == (SERVE_S, SERVE_K, 1, 16, SERVE_LATENT)
        assert lay["local"] == (SERVE_S // 2, SERVE_K, 1, 16, SERVE_LATENT)
        assert lay["placements"] == ["Shard(dim=0)", "Replicate()"]


def test_no_latent_gather_over_data(runs):
    """DTensor's own collectives over ``data`` move the [S] flags (one int
    a slot a rank), never a latent; the model axis carries the drift's
    tensor-parallel reductions; the port's own wire carries the drained
    results only (a latent a finished request a rank) and the loop
    condition's two words."""
    port, _ = runs
    lat = 16 * SERVE_LATENT
    for run in SERVE_RUNS:
        got = port["engines"][run]
        for (op, axis, dtype), (_, _, largest) in got["log"].items():
            if axis in ("data", "?") and op.startswith("all_gather"):
                assert largest <= SERVE_S // 2, (op, axis, dtype, largest)
        assert any(op == "all_reduce" and axis == "model"
                   for op, axis, _ in got["log"])
        wire = got["wire"]
        served = len(SERVE_REQS) + 1
        assert wire.get(("all_gather", "float32"), 0) <= 2 * served * lat * 4
        assert set(wire) <= {("all_gather", "float32"),
                             ("all_reduce_max", "int32")}


@pytest.mark.parametrize("name", ["lanes", "elastic", "overlap"])
def test_engine_features_on_mesh_match_one_device(runs, name):
    """Heterogeneous lanes, an elastic grid (2 to 4 slots: buckets that
    the data axis divides) and the overlap loop at 2 rounds a program."""
    port, _ = runs
    got = port["engines"][name]
    (mesh_out, mesh_st), (one_out, one_st) = got["mesh"], got["one"]
    _same_schedule(mesh_out, one_out)
    for rid in mesh_out:
        assert _rel(mesh_out[rid][0], one_out[rid][0]) < 1e-5, rid
    for key in STAT_KEYS:
        assert mesh_st[key] == one_st[key], (name, key)
    if name == "elastic":
        assert mesh_st["resizes"] >= 1
    if name == "overlap":
        assert mesh_st["speculations"] >= 1


def test_sharding_tag_and_cache_keys(runs):
    port, ref = runs
    keys = port["keys"]
    assert keys["tag"] == ref["tag"]
    assert keys["outside"] is None
    assert keys["retraces"] == 2  # one grid spec, two contexts
    bare, on_mesh = keys["specs"]
    assert "sharding=None" in bare and keys["tag"] in on_mesh


def test_slot_round_body_matches_reference(runs):
    port, ref = runs
    got = port["slot_rounds"]
    for name, m, o, r in zip(("x", "x_snap", "f_snap", "p", "finals"),
                             got["mesh"], got["one"], ref["slot_rounds"]):
        if name == "p":
            np.testing.assert_array_equal(m, r)
            np.testing.assert_array_equal(m, o)
            continue
        np.testing.assert_allclose(m, r, atol=1e-4, err_msg=name)
        assert _rel(m, o) < 1e-5 or not o.any(), name


def test_chords_engine_with_cores_on_data(runs):
    port, ref = runs
    static = port["static"]
    (m_out, m_rounds, m_wire, m_ran), (o_out, o_rounds, _, o_ran) = \
        static["mesh"], static["one"]
    r_out, r_rounds = ref["static"]
    _same_schedule(m_out, o_out)
    _same_schedule(m_out, r_out)
    assert m_rounds == o_rounds == r_rounds
    for rid in m_out:
        np.testing.assert_allclose(m_out[rid][0], r_out[rid][0], atol=1e-4)
        assert _rel(m_out[rid][0], o_out[rid][0]) < 1e-5
    # the wire: per round x and f (one core's latent each) and cur (one
    # int) to the next rank, and the emitting core's latent from every
    # rank; never the [K, ...] grid
    core = SERVE_S * 16 * SERVE_LATENT * 4  # one core's batch of latents
    assert m_ran == o_ran
    assert m_wire[("permute", "float32")] == 2 * core * m_ran
    assert m_wire[("permute", "int32")] == 4 * m_ran
    assert m_wire[("all_gather", "float32")] == core * m_ran


def test_kernels_on_local_shards(runs):
    port, _ = runs
    k = port["kernels"]
    np.testing.assert_array_equal(*k["step"])
    for name in ("accept_prev_dtensor", "accept_prev_plain"):
        got, ref, lays = k[name]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        assert all("Shard(dim=0)" in lay for lay in lays)
    got, ref, lays = k["ssd_chunk"]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert lays == ["(Shard(dim=0), Shard(dim=1))"] * 2
    # entry: a lane is live, nothing accepted; then one data block's new
    # accept stops every rank
    assert k["loop"] == (1, 0, [8, 1, 1, 0])
    assert k["redistributes"] == {}


def test_hybrid_on_mesh_matches_one_device(runs):
    port, _ = runs
    hyb = port["hybrid"]
    (mesh_out, mesh_st), (one_out, one_st) = hyb["mesh"], hyb["one"]
    _same_schedule(mesh_out, one_out)
    for rid in mesh_out:
        assert _rel(mesh_out[rid][0], one_out[rid][0]) < 1e-5, rid
    for key in STAT_KEYS:
        assert mesh_st[key] == one_st[key], key
    got, ref = hyb["ssd"]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) < 1e-5
