"""The port's static-analysis surface (``repro_torch.analysis``) on the CPU:
seeded mutants, the clean tree, the baseline flow, the launch descriptions
against the plans the wrappers used before them, and parity with the JAX
package's ``repro.analysis``.

Each mutant plants exactly one defect and asserts that its pass, and only
it, fires that code: overlapping output tiles (``ww-race``), too much
shared memory and more than 48 KB without the opt-in (``smem``), a shifted
origin (``oob-tile``), 65536 rows on ``gridDim.y`` (``launch-limit``, the
old geometry of the step and accept kernels), ``.to(torch.float64)``
(``dtype-64``), a closure float (``unstable-trace``), ``.item()``
(``host-sync``), a dropped value (``dead-code``), and each real kernel's
output tile pinned to one place (``ww-race``). The sharding pass runs on
four gloo ranks (``test_torch_mesh_ranks.py`` job ``analysis``) with its
``replicated`` and ``entry-spec`` mutants.
"""
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import pallas_check as j_pallas
from repro.analysis import surface as j_surface
from repro.analysis.report import Baseline as JBaseline
from repro.kernels.meta import BlockMeta
from repro_torch.analysis import (BASELINE_PATH, graph_lint, launch_check,
                                  sharding_check, surface, trace_check)
from repro_torch.analysis.report import Baseline, Finding, Report
from repro_torch.kernels.meta import CudaLaunch, OperandTile, dims3
from repro_torch.serve.executor import GridSpec, ProgramRecord
from test_torch_mesh_ranks import start_job, wait_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(findings):
    return sorted({(f.pass_name, f.code) for f in findings})


def _launch(out, grid=(2, 2), **kw):
    return CudaLaunch("mutant.k", dims3(*grid), dims3(32), (), (out,), **kw)


# --- seeded mutants: one defect, one pass (launch) ---------------------------

def test_mutant_overlapping_tiles_are_a_race():
    # every block writes tile (0, 0): a pure write-write race, no OOB
    out = OperandTile("o", (16, 16), "float32", (8, 8),
                      lambda bx, by, bz: (0, 0))
    found = launch_check.check_launch(_launch(out))
    assert _codes(found) == [("launch", "ww-race")], found
    assert "overlapping output tiles" in found[0].message


@pytest.mark.parametrize("smem,opt_in", [(240_000, True), (64 * 1024, False)])
def test_mutant_shared_memory_over_the_budget(smem, opt_in):
    """Over the 232,448 B a block may use, or over 48 KB without the
    cudaFuncSetAttribute opt-in: the launch is refused (error)."""
    out = OperandTile("o", (4, 8), "float32", (1, 8),
                      lambda bx, by, bz: (bx, 0))
    found = launch_check.check_launch(_launch(
        out, grid=(4,), dynamic_smem=smem, smem_opt_in=opt_in))
    assert _codes(found) == [("launch", "smem")], found
    assert found[0].severity == "error"


def test_shared_memory_over_half_the_budget_is_info():
    out = OperandTile("o", (4, 8), "float32", (1, 8),
                      lambda bx, by, bz: (bx, 0))
    found = launch_check.check_launch(_launch(
        out, grid=(4,), dynamic_smem=200_000, smem_opt_in=True))
    assert [(f.code, f.severity) for f in found] == [("smem", "info")]


def test_mutant_shifted_origin_is_oob():
    # origin i -> (i + 1) * 128 pushes the last tile one tile past the end
    out = OperandTile("o", (256,), "float32", (128,),
                      lambda bx, by, bz: ((bx + 1) * 128,))
    found = launch_check.check_launch(_launch(out, grid=(2,)))
    assert _codes(found) == [("launch", "oob-tile")], found
    # a masked tail is no stray access; a block wholly past the end still is
    tail = out._replace(origin=lambda bx, by, bz: (bx * 128 + 64,),
                        masked=(0,))
    assert launch_check.check_launch(_launch(tail, grid=(2,))) == []
    assert _codes(launch_check.check_launch(_launch(
        out._replace(masked=(0,)), grid=(2,)))) == [("launch", "oob-tile")]


def test_mutant_origin_arity_is_a_tile_map_error():
    out = OperandTile("o", (16,), "float32", (8,), lambda bx, by: (bx * 8,))
    found = launch_check.check_launch(_launch(out, grid=(2,)))
    assert _codes(found) == [("launch", "tile-map")], found
    rank = out._replace(origin=lambda bx, by, bz: (bx * 8, 0))
    assert _codes(launch_check.check_launch(_launch(rank, grid=(2,)))) == \
        [("launch", "tile-map")]


def _old_step_launch(rows, m):
    """The step kernel's launch before its rows were folded into x: column
    tiles on x, rows on y (what ``csrc/rectify.cu`` launched before)."""
    from repro_torch.kernels.rectify.kernel import step_plan
    p = step_plan(rows, m, True)
    width = p.threads * p.vec
    out = OperandTile("out", (rows, m), "float32", (1, width),
                      lambda bx, by, bz: (by, bx * width), (1,))
    return CudaLaunch("rectify.step_rectify_kernel",
                      dims3(-(-m // width), rows), dims3(p.threads), (),
                      (out,))


@pytest.mark.parametrize("rows", [65536, 65537])
def test_mutant_rows_on_grid_y_hit_the_launch_limit(rows):
    """The old geometry (rows on gridDim.y) is refused past 65535 rows;
    the folded launch of both kernels takes any row count and is clean."""
    from repro_torch.kernels.rectify.kernel import (launch_meta,
                                                    launch_meta_accept)
    found = launch_check.check_launch(_old_step_launch(rows, 64))
    assert _codes(found) == [("launch", "launch-limit")], found
    assert "gridDim.y" in found[0].message
    assert launch_check.check_launch(_old_step_launch(65535, 64)) == []
    assert launch_check.check_launch(launch_meta(rows, 64)) == []
    assert launch_check.check_launch(launch_meta_accept(rows, 64, 1)) == []


@pytest.mark.parametrize("threads,cluster", [(2048, 1), (32, 16),
                                             (32, 3)])
def test_launch_limits_threads_and_clusters(threads, cluster):
    """Over 1024 threads a block, a cluster over 8 blocks, a cluster
    that does not divide its grid dim."""
    out = OperandTile("o", (16,), "float32", (1,), lambda bx, by, bz: (bx,))
    launch = CudaLaunch("mutant.k", dims3(16), dims3(threads), (), (out,),
                        cluster=dims3(cluster))
    assert _codes(launch_check.check_launch(launch)) == \
        [("launch", "launch-limit")]


# --- seeded mutants: one defect, one pass (graph, trace) ---------------------

def _rec(fn, *args, kind="round", name="mutant"):
    return ProgramRecord(f"{name}/{kind}", kind, fn, args)


def test_mutant_to_f64_is_dtype_64():
    rec = _rec(lambda x: (x.to(torch.float64) * 2.0).to(torch.float32),
               torch.ones(8))
    lint = graph_lint.run([rec])
    assert _codes(lint) == [("graph", "dtype-64")], lint
    assert trace_check.run([rec]) == []  # the defect is the lint's alone


def test_mutant_closure_float_is_trace_instability():
    box = [0.0]

    def drifting(x):
        box[0] += 1.0  # a "temperature" float re-read at every trace
        return x * box[0]

    rec = _rec(drifting, torch.ones(8))
    assert _codes(trace_check.run([rec])) == [("trace", "unstable-trace")]
    # any single trace looks healthy to the lint
    assert graph_lint.run([rec]) == []


def test_mutant_item_is_a_host_sync():
    rec = _rec(lambda x: x * x.sum().item(), torch.ones(4))
    lint = graph_lint.run([rec])
    assert _codes(lint) == [("graph", "host-sync")], lint


def test_mutant_dropped_value_is_dead_code():
    def wasteful(x):
        _ = torch.cumsum(x * 3.0, 0)  # computed, never returned
        return x + 1.0

    lint = graph_lint.run([_rec(wasteful, torch.ones(8))])
    assert _codes(lint) == [("graph", "dead-code")], lint
    assert [f.location for f in lint] == ["mutant/round:cumsum"]


def test_mutant_scalar_widening_is_weak_widen():
    lint = graph_lint.run([_rec(lambda i: i * 0.5,
                                torch.ones(4, dtype=torch.int32),
                                kind="stream")])
    assert _codes(lint) == [("graph", "weak-widen")], lint


def test_mutant_state_dtype_change_is_carry_drift():
    st = (torch.zeros(4, dtype=torch.int32), torch.zeros(4))
    lint = graph_lint.run([_rec(lambda s: (s[0].float() + 1, s[1]), st)])
    assert _codes(lint) == [("graph", "carry-drift")], lint


def test_int64_in_outputs_is_dtype_64_but_not_inside():
    """torch's indexing returns int64 by design: inside a program it is
    fine, among its outputs (the state) it is flagged."""
    inside = _rec(lambda x: x.index_select(0, x.argmax().reshape(1)) + x,
                  torch.ones(4), kind="stream")
    assert graph_lint.run([inside]) == []
    out = _rec(lambda x: x.argmax(), torch.ones(4), kind="stream")
    assert _codes(graph_lint.run([out])) == [("graph", "dtype-64")]


# --- race detection: grid-order invariance, parity with the reference --------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("grid", [(2, 2), (3, 2), (4, 1), (2, 3)])
def test_race_detection_is_grid_order_invariant(seed, grid):
    out = OperandTile("o", (64, 64), "float32", (8, 8),
                      lambda i, j, k: (i // 2 * 8, j * 8))
    points = launch_check.grid_points(dims3(*grid))
    shuffled = list(points)
    random.Random(seed).shuffle(shuffled)
    assert launch_check.find_races(out, shuffled) == \
        launch_check.find_races(out, points)


@pytest.mark.parametrize("seed", range(8))
def test_find_races_equals_the_reference(seed):
    """On seeded random tilings (block shapes, index maps that may
    collide), the port's ``find_races`` over element origins returns
    exactly what ``repro.analysis.pallas_check.find_races`` returns over
    the same regions."""
    rng = np.random.default_rng(seed)
    grid = tuple(int(g) for g in rng.integers(1, 5, size=2))
    bs = tuple(int(b) for b in rng.integers(1, 9, size=2))
    a, c = (int(v) for v in rng.integers(1, 3, size=2))
    shift = int(rng.integers(0, 2))

    def jmap(i, j):
        return (i // a, (j + shift * i) // c)

    jmeta = BlockMeta("o", bs, jmap, (64, 64), "float32")
    tile = OperandTile("o", (64, 64), "float32", bs,
                       lambda i, j: tuple(x * b for x, b in
                                          zip(jmap(i, j), bs)))
    points = j_pallas.grid_points(grid)
    random.Random(seed).shuffle(points)
    want = j_pallas.find_races(jmeta, points)
    assert launch_check.find_races(tile, points) == want


def test_random_tilings_cover_races_and_none():
    """The seeds above include tilings that race and tilings that do not
    (so the parity is not only of empty lists)."""
    seen = set()
    for seed in range(8):
        rng = np.random.default_rng(seed)
        grid = tuple(int(g) for g in rng.integers(1, 5, size=2))
        bs = tuple(int(b) for b in rng.integers(1, 9, size=2))
        a, c = (int(v) for v in rng.integers(1, 3, size=2))
        shift = int(rng.integers(0, 2))
        jmeta = BlockMeta("o", bs, lambda i, j: (i // a, (j + shift * i)
                                                 // c), (64, 64), "float32")
        seen.add(bool(j_pallas.find_races(jmeta,
                                          j_pallas.grid_points(grid))))
    assert seen == {True, False}


# --- the real kernel launches ------------------------------------------------

REF_FIVE = ("flash_attention[2,256,4/2,64,float32,causal]",
            "rmsnorm[512x128,float32]", "ssd_scan[4,2,256,64,64]",
            "rectify[4x8192]", "rectify_accept[4x8192,p4]",
            "device_loop[4]")


@pytest.mark.parametrize("name", REF_FIVE)
def test_mutant_pinned_kernel_output_tile_is_a_race(name):
    """Each real kernel's first output tile pinned to the origin: every
    block then writes the same region. The device loop's one block cannot
    race with itself, so its mutant also launches two blocks."""
    case = {c.name: c for c in surface.kernel_cases()}[name]
    out = case.launch.outputs[0]
    rank = len(out.tile)
    pinned = out._replace(origin=lambda *idx: (0,) * rank)
    mutant = case.launch._replace(outputs=(pinned,) + case.launch.outputs[1:])
    if case.launch.blocks == 1:
        mutant = mutant._replace(grid=dims3(2))
    base = Baseline.load(BASELINE_PATH)
    found = [f for f in launch_check.check_launch(mutant)
             if f.key not in base.keys]
    assert _codes(found) == [("launch", "ww-race")], (name, found)
    assert [f for f in launch_check.check_launch(case.launch)
            if f.key not in base.keys] == []


def test_real_kernel_launches_are_clean():
    """Every case of the surface: no error or warning; the only findings
    are the baselined over-half-the-budget infos (one block an SM)."""
    base = Baseline.load(BASELINE_PATH)
    for case in surface.kernel_cases():
        for f in launch_check.check_launch(case.launch):
            assert f.severity == "info" and f.key in base.keys, \
                (case.name, f)


def test_kernel_oracles_agree_on_meta_tensors():
    for case in surface.kernel_cases():
        assert launch_check.check_oracle(case.name, case.alloc, case.ref,
                                         case.make("meta")) == [], case.name


def test_oracle_mismatch_is_caught():
    args = (torch.empty(4, device="meta"),)
    found = launch_check.check_oracle(
        "mutant", lambda x: torch.empty_like(x, dtype=torch.bfloat16),
        lambda x: x * 2, args)
    assert _codes(found) == [("launch", "oracle-mismatch")], found


# --- the launch descriptions give what the plans gave ------------------------

def _old_flash_plan(dtype, dh, b, sq, sk, h, causal):
    """flash's ``plan`` as it stood before ``launch_meta`` (grid, threads,
    dynamic shared bytes of ``csrc/flash_attention.cu``'s launchers)."""
    grid = ((sq + 63) // 64, h, b)
    if dtype == torch.bfloat16:
        n_kv = (sk + 63) // 64
        if causal:
            n_kv = min(n_kv, (sq + 63) // 64)
        tile = 2 * 64 * (dh + 8)
        return grid, 128, tile * (1 + 2 * (2 if n_kv > 1 else 1))
    return grid, 256, 4 * (64 * (dh + 1) + 64 * (dh + 1) + 64 * dh
                           + 64 * 65)


def _old_pick_group(g, nh, slots):
    """``csrc/ssd_scan.cu``'s ``pick_group`` before it moved to Python."""
    best, best_cost = 1, -1
    for hg in range(1, min(8, nh) + 1):
        blocks = g * ((nh + hg - 1) // hg)
        cost = (blocks + slots - 1) // slots * (3 * hg + 1)
        if best_cost < 0 or cost <= best_cost:
            best, best_cost = hg, cost
    return best


@pytest.mark.parametrize("b,sq,h,kvh,dh,dtype,causal", [
    (32, 64, 24, 24, 128, torch.bfloat16, False),    # row 4
    (2, 1024, 16, 16, 256, torch.bfloat16, True),    # row 4'
    (2, 1024, 16, 16, 256, torch.float32, True),     # row 4''
    (4, 512, 28, 4, 128, torch.bfloat16, True),      # row 4'''
    (4, 512, 16, 16, 256, torch.bfloat16, True),     # row 4''''
    (4, 512, 32, 32, 80, torch.bfloat16, True),      # row 4^5
    (4, 512, 16, 8, 128, torch.bfloat16, True)])     # row 4^6
def test_flash_meta_gives_the_old_plan(b, sq, h, kvh, dh, dtype, causal):
    from repro_torch.kernels.flash_attention.kernel import launch_meta, plan
    m = launch_meta(dtype, dh, b, sq, sq, h, kvh, causal)
    assert (m.grid, m.threads, m.dynamic_smem) == \
        _old_flash_plan(dtype, dh, b, sq, sq, h, causal)
    p = plan(dtype, dh, b, sq, sq, h, causal)
    assert (p.grid, p.threads, p.smem) == (m.grid, m.threads,
                                           m.dynamic_smem)
    assert m.smem_opt_in and m.static_smem == 0


@pytest.mark.parametrize("g,h,lc,per_sm", [(32, 80, 64, 2), (8, 80, 256, 1),
                                           (4, 2, 256, 1)])
def test_ssd_meta_at_132_sms_gives_the_old_group(g, h, lc, per_sm):
    """At 132 SMs and the blocks an SM held on the H100 (2 at Lc 64, 1 at
    Lc 256: ``device_slots`` on the card), the head group, grid and shared
    bytes the C launcher chose itself before the choice moved to Python;
    hg 5 and 512 blocks at the serving shape (row 5)."""
    from repro_torch.kernels.ssd_scan.kernel import (head_group, launch_meta,
                                                     resident_blocks)
    assert resident_blocks(lc, 64, 64) == per_sm
    m = launch_meta(g, h, lc, 64, 64, 132)
    hg = _old_pick_group(g, h, 132 * per_sm)
    assert head_group(m) == hg and m.grid == (g * -(-h // hg), 1, 1)
    tiles = (lc + 63) // 64
    floats = (tiles * 64 * 68 * 2 + 64 * 68 + 64 * 68 + 2 * 64 * 68
              + 2 * tiles * 64)
    assert m.dynamic_smem == 4 * floats and m.threads == 256
    if (g, h, lc) == (32, 80, 64):
        assert (hg, m.grid[0]) == (5, 512)


@pytest.mark.parametrize("rows,d,dtype", [
    (2048, 3072, torch.bfloat16), (2048, 2560, torch.bfloat16),
    (2048, 5120, torch.bfloat16), (4, 2560, torch.bfloat16),
    (4, 5120, torch.bfloat16), (2048, 2048, torch.bfloat16),
    (512, 128, torch.float32), (5, 5120, torch.float32)])
def test_rmsnorm_meta_gives_the_old_launch(rows, d, dtype):
    """Rows in registers: ceil(rows / rows_per_block) blocks of
    (threads_per_row, rows_per_block) and w in shared memory; two sweeps:
    one block of 256 a row, none."""
    from repro_torch.kernels.rmsnorm.kernel import (ROWS_IN_REGISTERS,
                                                    launch_meta, plan)
    p = plan(d, dtype, True)
    m = launch_meta(rows, d, dtype, dtype)
    if p.variant == ROWS_IN_REGISTERS:
        want = ((-(-rows // p.rows_per_block), 1, 1),
                (p.threads_per_row, p.rows_per_block, 1),
                dtype.itemsize * d)
    else:
        want = ((rows, 1, 1), (256, 1, 1), 0)
    assert (m.grid, m.block, m.dynamic_smem) == want
    assert m.static_smem == 32 and launch_check.check_launch(m) == []


@pytest.mark.parametrize("rows,m,p", [(32, 1024, 4), (4, 8192, 4),
                                      (8, 1024, 1), (16, 1024, 2),
                                      (7, 3, 7)])
def test_rectify_meta_gives_the_plans(rows, m, p):
    """The step kernel: rows x tiles blocks of ``step_plan``'s threads;
    the accept kernel: a cluster of ``accept_plan``'s blocks a row (the
    grids the old launches had, with the rows folded into x)."""
    from repro_torch.kernels.rectify.kernel import (accept_plan,
                                                    launch_meta,
                                                    launch_meta_accept,
                                                    step_plan)
    sp = step_plan(rows, m, True)
    sm = launch_meta(rows, m)
    assert sm.grid == (rows * -(-m // (sp.threads * sp.vec)), 1, 1)
    assert sm.block == (sp.threads, 1, 1) and sm.cluster == (1, 1, 1)
    ap = accept_plan(rows, m, True)
    am = launch_meta_accept(rows, m, p)
    assert am.grid == (rows * ap.cluster, 1, 1)
    assert am.block == (ap.threads, 1, 1)
    assert am.cluster == (ap.cluster, 1, 1) and am.static_smem == 128
    assert launch_check.check_launch(sm) == []
    assert launch_check.check_launch(am) == []


# --- the executor's programs -------------------------------------------------

def test_executor_programs_lint_clean_and_stable():
    ex = surface.make_executor()
    spec = GridSpec(num_slots=2, num_cores=3, latent_shape=(4,))
    recs = ex.enumerate_programs(grid_specs=[spec],
                                 migrate_pairs=[(spec, spec)])
    assert {r.kind for r in recs} == {"round", "admit", "multi", "roll",
                                      "migrate"}
    traced: list = []
    assert graph_lint.run(recs, traced) == []
    assert trace_check.run(recs, first=traced) == []
    # enumeration never builds a cached grid nor counts a retrace
    assert ex.retraces == 0 and ex.stream_traces == 0 and not ex._grids


def test_enumerated_names_equal_the_reference():
    """The surface's programs have the reference executor's names, in its
    order, for the same specs (both ladders, both stream specs, the
    migrate pairs)."""
    got = [(r.name, r.kind) for r in surface.enumerate_serve_programs()]
    want = [(r.name, r.kind) for r in j_surface.enumerate_serve_programs()]
    assert got == want
    assert len(got) == 34


def test_loop_programs_run_the_condition_kernel_in_the_graph():
    """``multi`` is linted as the loop program (entry condition, round,
    condition), with no host read of the condition inside."""
    ex = surface.make_executor()
    spec = GridSpec(num_slots=2, num_cores=2, latent_shape=(4,))
    rec = next(r for r in ex.enumerate_programs(grid_specs=[spec])
               if r.kind == "multi")
    gm, _ = graph_lint.trace(rec)
    ops = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert not any("_local_scalar_dense" in o or "is_nonzero" in o
                   for o in ops)
    assert sum("aten.any" in o for o in ops) >= 2  # the two conditions


# --- sharding ----------------------------------------------------------------

def test_sharding_helpers():
    from repro_torch.serve.executor import state_tensors

    assert sharding_check.data_axis_size(8, [4, 8, 16]) == 4
    assert sharding_check.data_axis_size(8, [8, 16]) == 8
    assert sharding_check.data_axis_size(8, [6]) == 2
    assert sharding_check.data_axis_size(1, [4]) == 1
    ex = surface.make_executor()
    for spec in (GridSpec(4, 2, (3, 5)), surface.lane_grid_ladder()[0]):
        st = next(r for r in ex.enumerate_programs(grid_specs=[spec])
                  if r.kind == "round").args[0]
        axes = sharding_check._axes_leaves(
            sharding_check.slot_state_axes(spec))
        leaves = state_tensors(st)
        assert len(axes) == len(leaves)
        for ax, leaf in zip(axes, leaves):
            assert len(ax) == leaf.dim(), (ax, leaf.shape)


def test_sharding_pass_skips_without_ranks():
    found = sharding_check.run(surface.make_executor(),
                               surface.grid_ladder())
    assert [(f.code, f.severity) for f in found] == [("skipped", "info")]


def test_sharding_pass_on_four_ranks(tmp_path):
    """Job ``analysis`` of ``test_torch_mesh_ranks.py``: the pass over
    both ladders on a (2, 2) gloo mesh under ``SERVE_RULES`` is clean;
    one leaf left whole fires ``replicated`` only, one leaf laid out on the
    wrong mesh dim ``entry-spec`` only."""
    import pickle

    wait_all(str(tmp_path), [start_job("analysis", str(tmp_path))])
    with open(tmp_path / "analysis.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["clean"] == [], out["clean"]
    assert out["grids"] == 6
    assert sorted({c for _, c in out["replicated"]}) == ["replicated"]
    assert sorted({c for _, c in out["entry_spec"]}) == ["entry-spec"]
    assert all("rtol" in loc or "('slots',)" in loc
               for loc, _ in out["replicated"])


# --- baseline / suppression workflow -----------------------------------------

def test_baseline_suppresses_by_key_and_reports_stale(tmp_path):
    f1 = Finding("graph", "dead-code", "warning", "prog:add", "dropped")
    f2 = Finding("launch", "smem", "error", "k:smem", "too big")
    report = Report(findings=[f1, f2])
    base = Baseline.from_findings([f1], "known: a dropped view")
    base.keys.add("trace:unstable-trace:gone")  # entry nothing produces
    assert [f.key for f in report.new_findings(base)] == [f2.key]
    doc = report.write(str(tmp_path / "r.json"), base)
    assert doc["counts"] == {"error": 1, "warning": 1, "info": 0}
    assert doc["baseline"]["stale_entries"] == ["trace:unstable-trace:gone"]
    assert json.load(open(tmp_path / "r.json")) == doc


def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"findings": [{"key": "a:b:c"}]}))
    with pytest.raises(ValueError, match="justification"):
        Baseline.load(str(p))


def test_checked_in_baseline_is_justified():
    base = Baseline.load(BASELINE_PATH)
    assert base.entries and all(e["justification"].strip()
                                for e in base.entries)


def test_finding_key_is_stable_identity():
    a = Finding("graph", "host-sync", "error", "loc", "one message")
    b = Finding("graph", "host-sync", "error", "loc", "another message")
    assert a.key == b.key == "graph:host-sync:loc"
    with pytest.raises(ValueError):
        Finding("graph", "x", "fatal", "loc", "bad severity")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_baseline_written_by_either_package_loads_in_the_other(tmp_path,
                                                               writer):
    entries = [{"key": "launch:smem:k:smem9", "justification": "one block"},
               {"key": "pallas:vmem:k:grid(1,)", "justification": "x"}]
    path = str(tmp_path / "baseline.json")
    (Baseline if writer == "port" else JBaseline)(
        keys={e["key"] for e in entries}, entries=entries).write(path)
    for cls in (Baseline, JBaseline):
        got = cls.load(path)
        assert got.keys == {e["key"] for e in entries}
        assert sorted(got.entries, key=lambda e: e["key"]) == \
            sorted(entries, key=lambda e: e["key"])


# --- end-to-end CLI ----------------------------------------------------------

def test_cli_full_surface_gates_clean(tmp_path):
    """``python -m repro_torch.analysis --fail-on-new --no-sharding``: the
    reference's 34 programs and every kernel case, no error or warning,
    nothing outside the baseline."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "report.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--fail-on-new",
         "--no-sharding", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    doc = json.load(open(out))
    assert doc["counts"]["error"] == 0 and doc["counts"]["warning"] == 0
    assert doc["baseline"]["new_findings"] == []
    assert len(doc["meta"]["programs"]) == 34
    assert len(doc["meta"]["kernels"]) == len(surface.kernel_cases())


def test_cli_gate_and_baseline_update(tmp_path, monkeypatch, capsys):
    """The gate fails on a finding outside the baseline, and
    ``--update-baseline`` writes it with the given justification, keeping
    an existing one (``run_all`` stubbed to a fixed report)."""
    import repro_torch.analysis as analysis
    from repro_torch.analysis.__main__ import main

    found = [Finding("launch", "smem", "info", "k:smem9", "big"),
             Finding("graph", "dead-code", "warning", "p:add", "dropped")]
    monkeypatch.setattr(analysis, "run_all",
                        lambda **kw: Report(findings=list(found), meta={
                            "programs": ["p"], "kernels": ["k"]}))
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"findings": [
        {"key": found[0].key, "justification": "one block an SM"}]}))
    args = ["--out", str(tmp_path / "r.json"), "--baseline", str(base)]
    assert main(args) == 0  # informational without --fail-on-new
    assert main(args + ["--fail-on-new"]) == 1
    assert "NEW [warning] graph:dead-code:p:add" in capsys.readouterr().out
    assert main(args + ["--update-baseline", "a dropped view"]) == 0
    got = {e["key"]: e["justification"]
           for e in json.load(open(base))["findings"]}
    assert got == {found[0].key: "one block an SM",
                   found[1].key: "a dropped view"}
    assert main(args + ["--fail-on-new"]) == 0
