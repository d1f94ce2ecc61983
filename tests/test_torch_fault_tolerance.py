"""The port's fault-tolerance layer (``repro_torch.dist.fault_tolerance``)
against the JAX package's: the scenarios of ``tests/test_dist.py`` run on
both modules, every observation recorded, and the two records held equal
(and to the values those tests assert) — dead workers and stragglers
under a fake clock, ``FileKVStore`` shared by two monitors,
``DictKVStore``, ``WorkerLost``, ``plan_elastic_mesh`` over a grid of
fleets and ``survivor_split``."""
import itertools
import os

import pytest

from repro.dist import fault_tolerance as jft
from repro_torch.dist import fault_tolerance as tft


def _dead_and_straggler(ft):
    t = [0.0]
    mon = ft.HeartbeatMonitor(num_workers=4, timeout_s=10,
                              clock=lambda: t[0])
    for w in range(4):
        for step in range(10):
            mon.beat(w, step, 1.0 if w != 3 else 3.5)  # worker 3 slow
    out = []
    t[0] = 5.0
    out += [mon.stragglers(), mon.dead_workers()]
    t[0] = 100.0
    out.append(mon.dead_workers())
    mon.mark_dead(3)
    out.append(mon.alive_count())
    # an even fleet's median, a monitor whose workers never beat
    t2 = [0.0]
    mon2 = ft.HeartbeatMonitor(num_workers=3, timeout_s=10,
                               straggler_factor=1.5, clock=lambda: t2[0])
    out.append(mon2.dead_workers())
    for w, d in ((0, 1.0), (1, 2.0)):
        mon2.beat(w, 0, d)
    out.append(mon2.stragglers())
    t2[0] = 11.0
    out += [mon2.dead_workers(), mon2.stragglers()]
    return out


def _file_store_two_monitors(ft, root):
    t = [0.0]
    store_a, store_b = ft.FileKVStore(root), ft.FileKVStore(root)
    mon_a = ft.HeartbeatMonitor(4, timeout_s=10, clock=lambda: t[0],
                                store=store_a)
    mon_b = ft.HeartbeatMonitor(4, timeout_s=10, clock=lambda: t[0],
                                store=store_b)
    for step in range(10):  # workers 0,1 beat via A; 2,3 via B
        for w in (0, 1):
            mon_a.beat(w, step, 1.0)
        for w in (2, 3):
            mon_b.beat(w, step, 3.5 if w == 3 else 1.0)
    out = []
    t[0] = 5.0
    out += [mon_a.stragglers(), mon_b.dead_workers()]
    t[0] = 20.0
    for w in (0, 1, 2):
        mon_a.beat(w, 11, 1.0)
    out.append(mon_b.dead_workers())
    mon_a.mark_dead(3)
    out += [mon_b.dead_workers(), mon_b.alive_count()]
    store_a.put("weird/key with spaces", "v")
    out += [store_b.get("weird/key with spaces"), store_b.get("nope"),
            sorted(store_b.items("dead/")), sorted(store_b.items("hb/"))]
    out.append(sorted(f for f in os.listdir(root) if f.startswith(".tmp.")))
    return out


def _dict_store(ft):
    t = [0.0]
    mon = ft.HeartbeatMonitor(2, timeout_s=10, clock=lambda: t[0],
                              store=ft.DictKVStore())
    mon.beat(0, 0, 1.0)
    t[0] = 5.0
    out = [mon.dead_workers()]
    t[0] = 100.0
    out.append(mon.dead_workers())
    mon.mark_dead(1)
    out += [mon.alive_count(), sorted(mon.store.items())]
    return out


def _worker_lost(ft):
    e = ft.WorkerLost([3, 1, 3], step=7, history=[{"step": 6}])
    return [e.workers, e.step, e.history, str(e),
            str(ft.WorkerLost([0]))]


def _plans(ft):
    out = []
    for hosts, dead, chips, mp, md in itertools.product(
            (1, 2, 4, 16, 128), (0, 1, 3, 5), (1, 4, 8), (1, 4, 16),
            (4, 16)):
        try:
            p = ft.plan_elastic_mesh(hosts, dead, chips_per_host=chips,
                                     model_parallel=mp, max_data=md)
            out.append((p.shape, p.axes, p.alive_hosts, p.idle_devices,
                        p.num_devices, p.data_parallel, p.model_parallel))
        except RuntimeError as e:
            out.append(("raised", str(e)))
    return out


def _splits(ft):
    out = []
    for total, dead in ((4, ()), (4, (1,)), (5, (0, 3)), (3, (2, 0))):
        out.append(ft.survivor_split(total, dead))
    try:
        ft.survivor_split(2, (0, 1))
    except RuntimeError as e:
        out.append(str(e))
    return out


def test_dead_workers_and_stragglers():
    ref = _dead_and_straggler(jft)
    assert ref[:4] == [[3], [], [0, 1, 2, 3], 3]
    assert _dead_and_straggler(tft) == ref


def test_file_kvstore_shared_by_two_monitors(tmp_path):
    ref = _file_store_two_monitors(jft, str(tmp_path / "jax"))
    assert ref[:5] == [[3], [], [3], [3], 3]
    assert _file_store_two_monitors(tft, str(tmp_path / "torch")) == ref


def test_dict_kvstore():
    ref = _dict_store(jft)
    assert ref[:2] == [[], [0, 1]]
    assert _dict_store(tft) == ref


def test_worker_lost():
    assert _worker_lost(tft) == _worker_lost(jft)


def test_plan_elastic_mesh_over_a_grid():
    ref = _plans(jft)
    assert any(r[0] == "raised" for r in ref)
    assert _plans(tft) == ref
    p = tft.plan_elastic_mesh(total_hosts=128, dead_hosts=5,
                              chips_per_host=4, model_parallel=16)
    assert p.num_devices == 256


def test_survivor_split():
    ref = _splits(jft)
    assert ref[1] == {0: 0, 2: 1, 3: 2}
    assert _splits(tft) == ref


def test_kvstore_protocol_and_no_jax():
    """The port's module is plain Python: no jax, no repro import."""
    import ast
    src = open(tft.__file__).read()
    mods = {n.module if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(ast.parse(src))
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in getattr(n, "names", [])}
    assert not {m for m in mods if m and m.split(".")[0] in ("jax", "repro")}
    with pytest.raises(RuntimeError):
        tft.plan_elastic_mesh(total_hosts=4, dead_hosts=4)
