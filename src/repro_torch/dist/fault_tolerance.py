"""Heartbeats, straggler detection, and elastic re-mesh planning — a copy
of ``repro.dist.fault_tolerance`` (plain Python: json, os, tempfile).

The trainer beats once per step per worker. ``stragglers`` flags workers
whose mean step time is an outlier against the fleet median (CHORDS-style
lockstep rounds run at the speed of the slowest core, so one slow host drags
the whole mesh). ``dead_workers`` is a pure timeout check with an injectable
clock for tests. ``plan_elastic_mesh`` answers "a host died — what is the
largest healthy mesh we can restart on?": model parallelism is fixed by the
checkpoint layout, so only the data axis shrinks, and it shrinks to a power
of two so collective rings stay balanced.

Heartbeat transport is pluggable: ``HeartbeatMonitor(store=...)`` writes
every beat (and dead-marks) through a :class:`KVStore` and merges the
store's view before answering liveness queries, so monitors in *different
processes* observe each other's workers. The default (``store=None``) stays
the in-process dict — zero-dependency, single-process, the behavior every
existing caller already has. :class:`FileKVStore` implements the protocol
over a shared directory with fsync'd atomic per-key files (tmp + rename),
which is what a multi-process fleet on a shared filesystem uses; an
etcd/GCS-backed store only needs the same three methods. Cross-host beat
timestamps come from each beating process's clock — production fleets want
NTP-synced hosts (same caveat as any lease-based liveness protocol).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Protocol, Tuple


class KVStore(Protocol):
    """Minimal key-value surface the heartbeat transport needs."""

    def put(self, key: str, value: str) -> None: ...

    def get(self, key: str) -> Optional[str]: ...

    def items(self, prefix: str = "") -> Dict[str, str]: ...


class DictKVStore:
    """In-process reference implementation (tests / single process)."""

    def __init__(self):
        self._d: Dict[str, str] = {}

    def put(self, key: str, value: str) -> None:
        self._d[key] = value

    def get(self, key: str) -> Optional[str]:
        return self._d.get(key)

    def items(self, prefix: str = "") -> Dict[str, str]:
        return {k: v for k, v in self._d.items() if k.startswith(prefix)}


class FileKVStore:
    """KVStore over a shared directory: one fsync'd file per key.

    Writes go to a tempfile in the same directory, are fsync'd, then
    ``os.replace``d into place — a reader never observes a torn value, only
    the old or the new one (same discipline as the checkpoint MANIFEST).
    Keys are percent-encoded into filenames so any string key works.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, urllib.parse.quote(key, safe=""))

    def put(self, key: str, value: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp.")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(value)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(key))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get(self, key: str) -> Optional[str]:
        try:
            with open(self._path(key)) as f:
                return f.read()
        except FileNotFoundError:
            return None

    def items(self, prefix: str = "") -> Dict[str, str]:
        out: Dict[str, str] = {}
        for name in os.listdir(self.root):
            if name.startswith(".tmp."):
                continue
            key = urllib.parse.unquote(name)
            if key.startswith(prefix):
                val = self.get(key)
                if val is not None:
                    out[key] = val
        return out


class WorkerLost(RuntimeError):
    """Raised out of the training loop when the heartbeat monitor declares
    workers dead. Carries enough for the launcher to run the elastic dance:
    mark dead -> ``plan_elastic_mesh`` -> restore checkpoint onto the new
    mesh -> rebalance the data-pipeline host split -> resume."""

    def __init__(self, workers, step: Optional[int] = None, history=None):
        self.workers = sorted(set(workers))
        self.step = step
        self.history = list(history) if history else []  # pre-failure metrics
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"workers {self.workers} lost{at}")


class HeartbeatMonitor:
    def __init__(self, num_workers: int, timeout_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 clock: Optional[Callable[[], float]] = None,
                 store: Optional[KVStore] = None):
        self.num_workers = num_workers
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        # beats written through a store are compared across processes/hosts,
        # which needs a shared epoch: wall clock (NTP-synced). Monotonic
        # clocks are boot-relative and incomparable between hosts — only
        # safe single-process, where they remain the default.
        if clock is None:
            clock = time.time if store is not None else time.monotonic
        self.clock = clock
        self.store = store
        self._start = clock()
        self._last_beat: Dict[int, float] = {}
        self._last_step: Dict[int, int] = {}
        self._dur_sum: Dict[int, float] = {}
        self._dur_n: Dict[int, int] = {}
        self._marked_dead: set = set()

    def beat(self, worker: int, step: int, duration_s: float):
        now = self.clock()
        self._last_beat[worker] = now
        self._last_step[worker] = step
        self._dur_sum[worker] = self._dur_sum.get(worker, 0.0) + duration_s
        self._dur_n[worker] = self._dur_n.get(worker, 0) + 1
        if self.store is not None:
            # the beating process owns this worker's accumulated history, so
            # the record is a full replacement, not a delta
            self.store.put(f"hb/{worker}", json.dumps(
                {"t": now, "step": step, "dur_sum": self._dur_sum[worker],
                 "dur_n": self._dur_n[worker]}))

    def _merge_store(self):
        """Fold other processes' beats/dead-marks into the local view.

        A stored record wins when its beat is newer than the local one —
        the local monitor may itself be the writer, in which case the merge
        is a no-op."""
        if self.store is None:
            return
        for key, val in self.store.items("hb/").items():
            try:
                w = int(key.split("/", 1)[1])
                rec = json.loads(val)
            except (ValueError, json.JSONDecodeError):
                continue
            if rec["t"] >= self._last_beat.get(w, float("-inf")):
                self._last_beat[w] = rec["t"]
                self._last_step[w] = rec["step"]
                self._dur_sum[w] = rec["dur_sum"]
                self._dur_n[w] = rec["dur_n"]
        for key in self.store.items("dead/"):
            try:
                self._marked_dead.add(int(key.split("/", 1)[1]))
            except ValueError:
                continue

    def _mean_durations(self, dead) -> Dict[int, float]:
        return {w: self._dur_sum[w] / self._dur_n[w]
                for w in self._dur_sum if w not in dead}

    def stragglers(self) -> List[int]:
        """Live workers whose mean step time exceeds factor x fleet median.

        Dead workers (marked or timed out) are excluded from both the
        candidates and the median, so their stale history cannot anchor it.
        """
        # dead_workers() merges the store first, so means see fresh beats
        means = self._mean_durations(set(self.dead_workers()))
        if len(means) < 2:
            return []
        vals = sorted(means.values())
        median = vals[len(vals) // 2] if len(vals) % 2 else \
            0.5 * (vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
        if median <= 0:
            return []
        return sorted(w for w, m in means.items()
                      if m > self.straggler_factor * median)

    def dead_workers(self) -> List[int]:
        """Workers marked dead or silent for longer than the timeout.

        A worker that has never beaten counts its silence from monitor
        creation, so a freshly started fleet is not declared dead at t=0.
        """
        self._merge_store()
        now = self.clock()
        out = set(self._marked_dead)
        for w in range(self.num_workers):
            last = self._last_beat.get(w, self._start)
            if now - last > self.timeout_s:
                out.add(w)
        return sorted(out)

    def mark_dead(self, worker: int):
        self._marked_dead.add(worker)
        if self.store is not None:
            self.store.put(f"dead/{worker}", "1")

    def alive_count(self) -> int:
        self._merge_store()
        return self.num_workers - len(self._marked_dead)


@dataclasses.dataclass(frozen=True)
class ElasticMeshPlan:
    shape: Tuple[int, ...]          # (pod, data, model)
    axes: Tuple[str, ...]
    alive_hosts: int
    idle_devices: int               # healthy chips the plan leaves unused

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_parallel(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def model_parallel(self) -> int:
        return self.shape[2]


def survivor_split(total_hosts: int, dead) -> Dict[int, int]:
    """Contiguous re-indexing of surviving hosts: {old_host: new_index}.

    After host loss the data pipeline's ``(host_index, host_count)`` split
    must stay gapless — survivors keep their relative order and compact down
    so every global-batch row is still produced exactly once.
    """
    dead = set(dead)
    alive = [h for h in range(total_hosts) if h not in dead]
    if not alive:
        raise RuntimeError(f"no alive hosts ({sorted(dead)} all dead)")
    return {h: i for i, h in enumerate(alive)}


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_elastic_mesh(total_hosts: int, dead_hosts: int,
                      chips_per_host: int = 4,
                      model_parallel: int = 16,
                      max_data: int = 16) -> ElasticMeshPlan:
    """Largest healthy (pod, data, model) mesh after ``dead_hosts`` losses.

    The model axis is pinned (checkpoint layout); total data-parallel ways
    shrink to the largest power of two that the surviving chips support.
    ``data`` caps at ``max_data`` (the within-pod ring); the remaining
    power-of-two factor becomes the pod axis.
    """
    alive = total_hosts - dead_hosts
    if alive <= 0:
        raise RuntimeError(
            f"no alive hosts ({dead_hosts}/{total_hosts} dead)")
    chips = alive * chips_per_host
    dp_total = chips // model_parallel
    if dp_total < 1:
        raise RuntimeError(
            f"{chips} chips cannot host model_parallel={model_parallel}")
    dp = _pow2_floor(dp_total)
    data = min(dp, max_data)
    pod = dp // data
    shape = (pod, data, model_parallel)
    used = pod * data * model_parallel
    return ElasticMeshPlan(shape=shape, axes=("pod", "data", "model"),
                           alive_hosts=alive, idle_devices=chips - used)
