"""Sharding contract checker: each slot-grid state leaf's layout against
the rule table — the counterpart of ``repro.analysis.sharding_check``.

Builds each :class:`GridSpec`'s programs under ``use_sharding(mesh,
rules)`` (``RoundExecutor.enumerate_programs``) on a mesh wider than one
rank and reads the DTensor placements of the ``SlotState`` the round
program takes, leaf for leaf against :func:`slot_state_axes` through the
rule table:

* ``entry-spec``  — a leaf whose placements or local shape differ from
                    what the rules give (error).
* ``replicated``  — a leaf the rules shard that arrives whole (all mesh
                    dims replicated, or not a DTensor): every rank holds
                    and updates all of it (error).
* ``skipped``     — no process group of two or more ranks to build the
                    mesh on; the CLI spawns them (``--ranks N``) (info).

Leaves the rule table itself leaves replicated (after the divisibility
fallback) are exempt from both checks, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import List, Sequence

from repro_torch.analysis.report import Finding

PASS = "sharding"


def slot_state_axes(spec):
    """Logical-axes tree matching the executor's ``SlotState`` leaf for
    leaf: slots ride ``data``, cores stay local once the slots hold it
    (a copy of the reference's)."""
    from repro_torch.core.chords import ChordsCarry, LaneState
    from repro_torch.serve.executor import SlotState

    nlat = len(spec.latent_shape)
    grid_lat = ("slots", "cores") + (None,) * nlat
    lat = ("slots",) + (None,) * nlat
    sk = ("slots", "cores")
    s = ("slots",)
    lanes = LaneState(pos=sk, f_norm=sk, stab=sk, skips=sk,
                      draft_on=s, skip_tau=s) \
        if getattr(spec, "lane_profile", None) is not None else ()
    return SlotState(
        carry=ChordsCarry(x=grid_lat, x_snap=grid_lat, f_snap=grid_lat,
                          p=sk, finals=grid_lat),
        i_arr=sk, rtol=s, rounds=s, live=s, done=s, has_last=s,
        last_out=lat, result=lat, rounds_used=s, chosen=s, lanes=lanes)


def _axes_leaves(axes) -> list:
    """The axis tuples of a :func:`slot_state_axes` tree, in leaf order."""
    if isinstance(axes, tuple) and axes and all(
            isinstance(a, (str, type(None))) for a in axes):
        return [axes]
    if isinstance(axes, tuple):
        return [x for a in axes for x in _axes_leaves(a)]
    return []


def data_axis_size(device_count: int, slot_counts: Sequence[int]) -> int:
    """Largest power-of-two mesh size <= device_count dividing every S."""
    d = 1
    while (d * 2 <= device_count
           and all(s % (d * 2) == 0 for s in slot_counts)):
        d *= 2
    return d


def _local_shape(shape, placements, mesh) -> tuple:
    from torch.distributed.tensor import Shard

    local = list(shape)
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= int(mesh.shape[md])
    return tuple(local)


def check_grid_state(executor, spec, mesh, rules) -> List[Finding]:
    """Build one GridSpec's programs under the mesh; hold every leaf of
    the state its round program takes to the rule table."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import ShardingCtx, use_sharding
    from repro_torch.serve.executor import (ambient_sharding_tag,
                                            state_tensors)

    ctx = ShardingCtx(mesh, rules)
    findings: List[Finding] = []
    with use_sharding(mesh, rules):
        tagged = dataclasses.replace(spec, sharding=ambient_sharding_tag())
        rec = next(r for r in executor.enumerate_programs(
            grid_specs=[tagged]) if r.kind == "round")
    st = rec.args[0]
    leaves = state_tensors(st)
    axes = _axes_leaves(slot_state_axes(tagged))
    if len(axes) != len(leaves):
        raise ValueError(f"{rec.name}: {len(leaves)} state leaves but "
                         f"{len(axes)} axis tuples")
    for ax, leaf in zip(axes, leaves):
        shape = tuple(int(d) for d in leaf.shape)
        want = tuple(ctx.placements(ax, shape))
        if all(isinstance(p, Replicate) for p in want):
            continue  # the rules leave this leaf replicated: expected
        loc = f"{rec.name}:{ax}{shape}"
        got = tuple(leaf.placements) if isinstance(leaf, DTensor) else None
        if got is None or all(isinstance(p, Replicate) for p in got):
            findings.append(Finding(
                PASS, "replicated", "error", loc,
                f"{rec.name}: leaf {ax} {shape} arrives whole "
                f"({'a plain tensor' if got is None else got}) although "
                f"the rules lay it out {want} — every rank holds and "
                f"updates all of it"))
            continue
        want_local = _local_shape(shape, want, mesh)
        got_local = tuple(leaf.to_local().shape)
        if got != want or got_local != want_local:
            findings.append(Finding(
                PASS, "entry-spec", "error", loc,
                f"{rec.name}: leaf {ax} {shape} enters as {got} with local "
                f"shape {got_local}; the rules give {want}, local "
                f"{want_local}"))
    return findings


def serving_mesh(world: int, slot_counts: Sequence[int]):
    """The (data, model) mesh the pass checks on ``world`` ranks: data
    the largest power of two up to 2 dividing every S, model the rest; None
    where that is one rank."""
    data = data_axis_size(min(world, 2), slot_counts)
    if world < 2 or world % data:
        return None
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((data, world // data), ("data", "model"),
                     device="cpu")


def run(executor, grid_specs, rules=None, mesh=None) -> List[Finding]:
    """Check every GridSpec on ``mesh`` (by default :func:`serving_mesh`
    over the process group's ranks)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import SERVE_RULES

    rules = dict(SERVE_RULES if rules is None else rules)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh is None and world >= 2:
        mesh = serving_mesh(world, [s.num_slots for s in grid_specs])
    if mesh is None or mesh.size() < 2:
        return [Finding(
            PASS, "skipped", "info", f"ranks={world}",
            f"sharding pass needs a process group of >= 2 ranks (have "
            f"{world}); run via the CLI with --ranks N")]
    findings: List[Finding] = []
    for spec in grid_specs:
        findings.extend(check_grid_state(executor, spec, mesh, rules))
    return findings


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One spawned rank: join a gloo group (FileStore rendezvous in
    ``tmp``), run the pass over the surface's ladders, rank 0 writes the
    findings."""
    import torch
    import torch.distributed as dist

    from repro_torch.analysis import surface

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        found = run(surface.make_executor(),
                    surface.grid_ladder() + surface.lane_grid_ladder())
        if rank == 0:
            with open(os.path.join(tmp, "findings.json"), "w") as f:
                json.dump([x.to_json() for x in found], f)
    finally:
        dist.destroy_process_group()


def run_on_ranks(ranks: int) -> List[Finding]:
    """:func:`run` on ``ranks`` gloo ranks of this host, spawned here as
    processes of their own (``launch/train.py --mesh`` does the same)."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_analysis_")
    try:
        mp.start_processes(_rank_main, args=(ranks, tmp), nprocs=ranks,
                           start_method="spawn")
        with open(os.path.join(tmp, "findings.json")) as f:
            return [Finding(**d) for d in json.load(f)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
