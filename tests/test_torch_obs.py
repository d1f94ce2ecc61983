"""The port's trace export and check (``repro_torch.obs``) on the CPU, after
the reference's ``tests/test_obs.py``.

The trace of an overlap engine on an elastic 2..4 grid under burst
pressure, with a tolerance tight enough that speculative admissions roll
back: structurally valid Chrome trace-event JSON, the request lifecycle,
rollbacks, resizes and migrations in it, spans nested per track, and
``check`` passing (its rollback cap failing). The JAX package's own
``repro.obs.check.check`` accepts the port's trace, and on a port trace
and on a reference trace both checkers give the same verdict and the same
report and summary lines. The instants of both packages' traces of the
same run agree in number. A disabled tracer is bitwise-neutral. The
launcher's ``--trace-out`` file passes ``python -m repro_torch.obs check``.
"""
import json
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
from repro.obs import Tracer as JTracer
from repro.obs import check as j_check
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve.sched import workload as jwl
from repro_torch.core.ode import uniform_tgrid
from repro_torch.obs import (METRICS_SCHEMA, NULL_TRACER, MetricsRegistry,
                             Tracer, chrome_trace, load_snapshot,
                             load_trace, metric_scalar, write_chrome_trace)
from repro_torch.obs.check import check, diff, summarize, validate_structure
from repro_torch.obs.render import GROUPS, format_stats
from repro_torch.serve import ContinuousEngine, Request
from repro_torch.serve.sched import workload as twl

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K = 16, 4
LAM = np.linspace(0.1, 1.5, 4).astype(np.float32)
J_LAM, T_LAM = jnp.asarray(LAM), torch.from_numpy(LAM)
ELASTIC = dict(rtol=1e-5, min_slots=2, max_slots=4, resize_hysteresis=8,
               overlap=True)


def _tdrift(x, t):
    return -x * T_LAM


def _jdrift(x, t):
    return -x * J_LAM


def _x0(seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (4,)))


def _serve(tracer=None, n_req=3, rtol=0.0, **kw):
    eng = ContinuousEngine(_tdrift, (4,), N, K, uniform_tgrid(N, 0.98),
                           rtol=rtol, tracer=tracer, device="cpu", **kw)
    for i in range(n_req):
        eng.submit(Request(rid=i, seed=i, x0=_x0(i)))
    with torch.no_grad():
        return eng, dict(eng.run_until_drained())


@pytest.fixture(scope="module")
def rollback_run(tmp_path_factory):
    """The reference's trace configuration: overlap engine, elastic 2..4
    slots, the bursty trace at rtol 1e-5 (cold-start predictions wrong,
    so speculative admissions roll back), traced and exported."""
    eng = ContinuousEngine(_tdrift, (4,), N, K, uniform_tgrid(N, 0.98),
                           tracer=Tracer(), device="cpu", **ELASTIC)
    reqs, arrivals = twl.bursty_trace(N, rtol=1e-5)
    for r in reqs:
        r.x0 = _x0(r.seed)
    with torch.no_grad():
        out = twl.drive(eng, reqs, arrivals)
    path = tmp_path_factory.mktemp("obs") / "trace.json"
    doc = eng.write_trace(str(path), meta={"run": "test"})
    return eng, out, doc, str(path)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The same run through the JAX package's engine and exporter."""
    eng = JContinuousEngine(_jdrift, (4,), N, K, j_tgrid(N, 0.98),
                            tracer=JTracer(), **ELASTIC)
    out = jwl.drive(eng, *jwl.bursty_trace(N, rtol=1e-5))
    path = tmp_path_factory.mktemp("obs_ref") / "trace.json"
    doc = eng.write_trace(str(path), meta={"run": "test"})
    return eng, out, doc, str(path)


# -- the trace artifact -------------------------------------------------------

def test_trace_is_structurally_valid(rollback_run):
    _, _, doc, path = rollback_run
    assert validate_structure(doc) == []
    assert doc["otherData"]["schema"] == "repro.obs.trace"
    assert doc["otherData"]["dropped"] == 0
    assert doc["otherData"]["meta"]["run"] == "test"
    json.loads(json.dumps(doc))  # no tensors or numpy scalars in args
    assert load_trace(path) == json.loads(json.dumps(doc))


def test_trace_contains_request_lifecycle(rollback_run):
    _, out, doc, _ = rollback_run
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"request/submit", "request/queued", "request/compute",
            "verify/readback"} <= names
    assert any(n.startswith("dispatch/") for n in names)
    rids = {e["args"].get("rid") for e in doc["traceEvents"]
            if e["name"] == "request/compute"}
    assert set(out) <= rids


def test_trace_has_rollback_resize_and_migration(rollback_run):
    eng, _, doc, _ = rollback_run
    names = [e["name"] for e in doc["traceEvents"]]
    st = eng.stats()
    assert names.count("spec/rollback") == st["speculation_rollbacks"] >= 1
    assert names.count("spec/confirm") == st["speculation_confirms"]
    assert names.count("resize/grow") == st["grows"] >= 1
    assert names.count("resize/shrink") == st["shrinks"]
    assert names.count("dispatch/migrate") == names.count("migrate/lanes")
    migrated = sum(e["args"]["lanes"] for e in doc["traceEvents"]
                   if e["name"] == "migrate/lanes")
    assert migrated == st["migrations"] >= 1


def test_spans_nest_despite_rollbacks(rollback_run):
    _, _, doc, _ = rollback_run
    slot_spans = [e for e in doc["traceEvents"]
                  if e.get("ph") == "X" and e["pid"] == 2]
    assert slot_spans
    assert validate_structure({"traceEvents": slot_spans}) == []


def test_check_passes_on_real_trace(rollback_run):
    _, _, doc, _ = rollback_run
    ok, lines = check(doc)
    assert ok, lines
    assert sum(1 for ln in lines if ln.lstrip().startswith("PASS")) >= 4


def test_check_rollback_cap_fails(rollback_run):
    _, _, doc, _ = rollback_run
    ok, lines = check(doc, max_rollbacks=0)
    assert not ok
    assert any("rollback-cap" in ln and "FAIL" in ln for ln in lines)


def test_summarize_reports_phases(rollback_run):
    _, _, doc, _ = rollback_run
    text = "\n".join(summarize(doc))
    assert "request/compute" in text and "dispatch/migrate" in text
    assert "spec/rollback=" in text and "rollback offenders" in text


def test_cli_on_artifact(rollback_run, capsys):
    from repro_torch.obs.__main__ import main
    _, _, _, path = rollback_run
    assert main(["check", path]) == 0
    assert main(["summarize", path]) == 0
    assert main(["diff", path, path]) == 0
    assert main(["check", path, "--max-rollbacks", "0"]) == 1
    assert "obs check: OK" in capsys.readouterr().out


# -- the two packages' checkers -----------------------------------------------

@pytest.mark.parametrize("which", ["port", "reference"])
def test_checkers_agree(which, rollback_run, reference_run):
    """The reference's checker accepts the port's trace, and on either
    package's trace both checkers report the same lines and verdict."""
    doc = (rollback_run if which == "port" else reference_run)[2]
    for kw in ({}, {"max_rollbacks": 0}, {"max_gap_s": 1e-9}):
        assert check(doc, **kw) == j_check.check(doc, **kw), kw
    assert j_check.check(doc)[0]
    assert summarize(doc) == j_check.summarize(doc)
    assert validate_structure(doc) == j_check.validate_structure(doc)
    snap_a, snap_b = rollback_run[2], reference_run[2]
    assert diff(load_snapshot_doc(snap_a), load_snapshot_doc(snap_b)) == \
        j_check.diff(load_snapshot_doc(snap_a), load_snapshot_doc(snap_b))


def load_snapshot_doc(doc):
    return doc["otherData"]["metrics"]


def test_trace_instants_match_reference(rollback_run, reference_run):
    """The same run in both packages leaves the same lifecycle, speculation,
    resize and migration instants (the builds differ: the port builds its
    whole ladder at construction, the reference each bucket on first use)."""
    def counts(doc):
        c = {}
        for e in doc["traceEvents"]:
            if e.get("ph") == "i" and e["name"] != "retrace":
                c[e["name"]] = c.get(e["name"], 0) + 1
        return c

    assert counts(rollback_run[2]) == counts(reference_run[2])
    for name in ("serve.spec.rollbacks", "serve.resize.migrations",
                 "serve.host_syncs", "serve.rounds_total"):
        assert metric_scalar(load_snapshot_doc(rollback_run[2]), name) == \
            metric_scalar(load_snapshot_doc(reference_run[2]), name), name


# -- disabled parity, buffers, snapshots --------------------------------------

def test_disabled_tracer_is_bitwise_neutral():
    eng_off, out_off = _serve(tracer=None)
    eng_on, out_on = _serve(tracer=Tracer())
    assert sorted(out_off) == sorted(out_on)
    for rid in out_off:
        assert torch.equal(out_off[rid].sample, out_on[rid].sample), rid
        assert out_off[rid].rounds_used == out_on[rid].rounds_used
    assert eng_off.tracer is NULL_TRACER
    assert len(eng_off.tracer.events) == 0
    assert len(eng_on.tracer.events) > 0


def test_null_tracer_records_nothing():
    t = Tracer(enabled=False)
    assert t.now() == 0.0
    t.instant("spec/rollback", round_idx=3)
    t.span("request/compute", 0.0, round_idx=1)
    t.counter("occupancy", 1.0)
    with t.dispatch_span("round", round_idx=0):
        pass
    t.label_track(("slots", 0), "slot 0")
    assert len(t) == 0 and t.dropped == 0 and t.track_labels == {}
    assert t.dispatch_span("round") is t.dispatch_span("admit")


def test_ring_buffer_counts_drops():
    t = Tracer(capacity=4)
    for i in range(10):
        t.instant("retrace", round_idx=i)
    assert len(t) == 4 and t.dropped == 6
    doc = chrome_trace(t)
    assert doc["otherData"]["dropped"] == 6
    assert doc["otherData"]["events"] == 4
    rounds = [e["args"]["round"] for e in doc["traceEvents"]
              if e["name"] == "retrace"]
    assert rounds == [0, 1, 2, 3]


def test_snapshot_roundtrip_bare_and_embedded(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serve.host_syncs").inc(5)
    reg.gauge("serve.overlap").set(1.0)
    bare = tmp_path / "metrics.json"
    reg.write_snapshot(str(bare))
    snap = load_snapshot(str(bare))
    assert snap["schema"] == METRICS_SCHEMA
    assert metric_scalar(snap, "serve.host_syncs") == 5
    trace = tmp_path / "trace.json"
    write_chrome_trace(str(trace), Tracer(), metrics=reg)
    assert load_snapshot(str(trace)) == snap
    other = tmp_path / "other.json"
    other.write_text("{}")
    with pytest.raises(ValueError):
        load_snapshot(str(other))
    with pytest.raises(ValueError):
        load_trace(str(other))


def _snap(**scalars):
    return {"schema": METRICS_SCHEMA, "version": 1,
            "metrics": {k: {"type": "counter", "value": v}
                        for k, v in scalars.items()}}


def test_diff_threshold_semantics():
    a = _snap(**{"serve.spec.rollbacks": 0, "serve.host_syncs": 100,
                 "serve.served": 10})
    b = _snap(**{"serve.spec.rollbacks": 3, "serve.host_syncs": 110,
                 "serve.served": 20})
    _, regressions = diff(a, b, threshold=0.25)
    assert "serve.spec.rollbacks" in regressions
    assert "serve.host_syncs" not in regressions
    assert "serve.served" not in regressions
    _, tight = diff(a, b, threshold=0.05)
    assert "serve.host_syncs" in tight
    assert diff(b, a, threshold=0.0)[1] == []


def test_validate_structure_catches_malformed():
    good = {"name": "a", "ph": "X", "pid": 1, "tid": 0, "ts": 0.0,
            "dur": 10.0}
    overlap = dict(good, name="b", ts=5.0, dur=10.0)
    nested = dict(good, name="c", ts=2.0, dur=3.0)
    missing = {"name": "d", "ph": "i", "pid": 1, "tid": 0}
    meta = {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "host"}}
    assert validate_structure({"traceEvents": [good, nested, meta]}) == []
    probs = validate_structure({"traceEvents": [good, overlap, missing]})
    assert any("partially overlaps" in p for p in probs)
    assert any("missing" in p and "'d'" in p for p in probs)
    assert validate_structure(
        {"traceEvents": [dict(good, dur=-1.0)]}) != []


def test_render_covers_every_stat_key(rollback_run):
    eng, _, _, _ = rollback_run
    st = eng.stats()
    text = " ".join(format_stats(st))
    for key in st:
        assert text.count(f" {key}=") == 1, key
    grouped = {k for _, keys in GROUPS for k in keys}
    assert set(st) - grouped <= {"accept_rounds_observed"}, \
        sorted(set(st) - grouped)


# -- the launcher and the CLI, as a user runs them ----------------------------

def test_launcher_elastic_lanes_trace_on_cpu(tmp_path):
    """``--min-slots/--max-slots``, ``--lane-mode`` and ``--trace-out`` on
    the CPU: the run ends with 0 and its trace passes ``python -m
    repro_torch.obs check`` (and the reference's checker)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    path = tmp_path / "serve_trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--steps", "12", "--cores", "4", "--requests",
         "6", "--slots", "2", "--min-slots", "1", "--max-slots", "4",
         "--resize-hysteresis", "2", "--lane-mode", "adaptive",
         "--overlap", "--trace-out", str(path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "lane_modes_enabled=true" in proc.stdout
    assert "min_slots=1 max_slots=4" in proc.stdout
    chk = subprocess.run([sys.executable, "-m", "repro_torch.obs", "check",
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert chk.returncode == 0, chk.stdout + chk.stderr
    assert "obs check: OK" in chk.stdout
    doc = load_trace(str(path))
    assert j_check.check(doc)[0]
    st = doc["otherData"]["metrics"]["metrics"]
    assert st["serve.resize.count"]["value"] >= 1
    assert st["serve.lanes.served_nonexact"]["value"] == 6
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--static", "--lane-mode", "draft"],
        env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "continuous engine" in bad.stderr
