"""Atomic, checksummed, GC'd sharded checkpoints of nested tensor trees —
port of ``repro.dist.checkpoint``.

The on-disk format is the reference's v2, so each package restores the
other's checkpoints:

    <dir>/step_00000015/
        leaf_00000.shard_000.npy ...        one file per (leaf, shard)
        MANIFEST                            json: step, mesh, per-shard sha256

Leaves are numbered in the order of JAX's ``tree_flatten`` (dict keys
sorted; ``utils/tree.py``). With a ``ShardingCtx`` and a logical-axes tree
(``save(..., ctx=, axes=)``) every leaf is cut into the shard grid of
``ctx.shard_spec`` — dim ``d`` split ``grid[d]`` ways, shard files in C
order — the same files and MANIFEST as the reference's for the same state
and ctx; without them every leaf is one shard. ``restore_latest`` reassembles
each leaf on the host and, given ``ctx``/``axes`` on a ``DeviceMesh``, lays
it out as a DTensor on that (possibly other) mesh. bf16 leaves are widened
to f32 on disk and the dtype recorded (``bfloat16``, numpy's names);
restore casts every leaf to the template leaf's dtype and device.

A step directory without a MANIFEST is a crashed partial write and is
ignored. ``restore_latest`` walks complete steps newest-first and re-verifies
every shard's checksum, falling back to the previous step on any mismatch,
torn file, or missing shard. Format v1 directories (one ``leaf_i.npy`` per
leaf) restore too.

Multi-writer protocol (``process_count > 1``), numpy and the file system
only: every process calls ``save`` with its ``process_index``; shards are
dealt round-robin by global shard index. Writers stage into a shared
deterministic ``.stage_step_NNNNNNNN`` directory; only process 0 — which
callers must barrier behind the others — hashes all staged shards, writes
the MANIFEST, and renames the staging dir into place. Ranks of a mesh save
together (``barrier=``, a callable): each writes the shards dealt to it —
from its own DTensor block where that block holds the shard, else from the
leaf's full value, gathered by every rank at once — then all wait, process
0 finalizes, and all wait again.
"""
from __future__ import annotations

import hashlib
import io
import json
import math
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import sharding as shlib
from repro_torch.dist.sharding import is_dtensor, shard_slices
from repro_torch.utils.tree import tree_flatten, tree_unflatten

MANIFEST = "MANIFEST"
FORMAT_VERSION = 2
_STEP_FMT = "step_{:08d}"
_STAGE_FMT = ".stage_step_{:08d}"


class TemplateMismatch(ValueError):
    """The restore template's tree does not match what's on disk — a caller
    bug (changed arch / optimizer config pointed at an old ckpt dir), not
    disk corruption: ``restore_latest`` raises it instead of silently
    skipping every checkpoint and restarting at step 0."""


def _to_savable(leaf) -> Tuple[np.ndarray, str]:
    """(array numpy can np.save losslessly, original dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    orig = str(arr.dtype)
    if arr.dtype.kind not in "biufc":  # e.g. ml_dtypes bfloat16 -> kind 'V'
        arr = arr.astype(np.float32)
    return arr, orig


def _dtype_name(leaf) -> str:
    """numpy's name of the leaf's dtype ("bfloat16" for torch's bf16)."""
    if isinstance(leaf, torch.Tensor):
        return "bfloat16" if leaf.dtype == torch.bfloat16 else \
            str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _shard_name(leaf: int, shard: int) -> str:
    return f"leaf_{leaf:05d}.shard_{shard:03d}.npy"


def _flatten_axes(axes_tree: Any, n_leaves: int) -> Optional[list]:
    """A logical-axes tree (leaves are tuples of str|None) as a list
    aligned with the state's flattened leaves; None if absent."""
    if axes_tree is None:
        return None
    out = []

    def walk(t):
        if isinstance(t, tuple):
            out.append(t)
        else:
            for k in sorted(t):
                walk(t[k])

    walk(axes_tree)
    if len(out) != n_leaves:
        raise ValueError(
            f"axes tree has {len(out)} leaves, state has {n_leaves}")
    return out


def _is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def _held_region(leaf, coord) -> Tuple[Tuple[int, int], ...]:
    """(start, stop) per dim of the block a rank at mesh coordinate
    ``coord`` holds of DTensor ``leaf`` (Shard dims split with the earlier
    mesh dim outer)."""
    from torch.distributed.tensor import Shard

    sizes = tuple(leaf.device_mesh.shape)
    out = []
    for d, n in enumerate(leaf.shape):
        ways, idx = 1, 0
        for md, pl in enumerate(leaf.placements):
            if isinstance(pl, Shard) and pl.dim == d:
                idx = idx * sizes[md] + int(coord[md])
                ways *= sizes[md]
        b = int(n) // ways
        out.append((idx * b, (idx + 1) * b))
    return tuple(out)


def _within(sl, region) -> bool:
    return all(r0 <= s.start and s.stop <= r1
               for s, (r0, r1) in zip(sl, region))


def _load_verified(path: str, sha256: str) -> np.ndarray:
    """Read once, hash the bytes, parse from memory — no double disk read."""
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != sha256:
        raise IOError(f"checksum mismatch in {path}")
    return np.load(io.BytesIO(data))


def _place_like(arr: np.ndarray, ref, ctx=None, axes_leaf=None) -> Any:
    """``arr`` as the template leaf's type: a tensor of its dtype on its
    device, or a numpy array of its dtype; with a ``ctx`` on a
    ``DeviceMesh`` and the leaf's axes, a DTensor laid out on that mesh
    (the re-slice half of the elastic restore)."""
    if isinstance(ref, torch.Tensor):
        if not (arr.flags["C_CONTIGUOUS"] and arr.flags["WRITEABLE"]):
            arr = arr.copy()  # (np.ascontiguousarray would make 0-d 1-d)
        t = torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
        if ctx is not None and axes_leaf is not None and t.dim() > 0 \
                and _is_device_mesh(ctx.mesh):
            return shlib.local_dtensor(
                t, ctx.mesh, ctx.placements(axes_leaf, tuple(t.shape)))
        return t
    dtype = getattr(ref, "dtype", None)
    return arr if dtype is None else arr.astype(dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._sweep_partial(include_stage=True)

    def _sweep_partial(self, include_stage: bool = False):
        """Remove debris from hard crashes (SIGKILL/power loss mid-save):
        leftover tmp dirs and step dirs that never got their MANIFEST.
        Shared multi-writer staging dirs are only swept at manager init
        (``include_stage``) — mid-run they may hold another writer's shards."""
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if not os.path.isdir(path):
                continue
            stale = name.startswith(".tmp_save_") or \
                (include_stage and name.startswith(".stage_step_"))
            torn_step = name.startswith("step_") and \
                not os.path.isfile(os.path.join(path, MANIFEST))
            if stale or torn_step:
                shutil.rmtree(path, ignore_errors=True)

    # -- save -----------------------------------------------------------------

    def save(self, state: Any, step: int, ctx=None, axes: Any = None,
             process_index: int = 0, process_count: int = 1,
             barrier=None) -> Optional[str]:
        """Write step ``step``; returns the final step dir (finalizing writer)
        or None (non-finalizing writers in the multi-host protocol).

        ``ctx`` (a ``ShardingCtx``) + ``axes`` (logical-axes tree mirroring
        ``state``) turn on sharded writes: each leaf is split into the shard
        grid its pspec implies. Without them every leaf is one shard.
        ``barrier``: the ranks of a mesh call ``save`` together and it
        waits for all of them before and after process 0 finalizes."""
        leaves, _ = tree_flatten(state)
        axes_leaves = _flatten_axes(axes, len(leaves))
        multi = process_count > 1
        if not multi:
            self._sweep_partial()
            tmp = tempfile.mkdtemp(prefix=".tmp_save_", dir=self.dir)
        else:
            tmp = os.path.join(self.dir, _STAGE_FMT.format(int(step)))
            os.makedirs(tmp, exist_ok=True)

        try:
            plan = self._write_shards(tmp, leaves, axes_leaves, ctx,
                                      process_index, process_count)
            if barrier is not None:
                barrier()
            final = None
            if process_index == 0:
                final = self._finalize(tmp, step, plan, ctx)
        except BaseException:
            if not multi:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        if barrier is not None:
            barrier()
        if process_index != 0:
            return None  # process 0 finalizes after the fleet barrier
        self._gc()
        return final

    def _write_shards(self, tmp: str, leaves, axes_leaves, ctx,
                      process_index: int, process_count: int):
        """Write this process's shards; return the per-leaf shard plan.
        Each shard is serialized to memory once, hashed, and written — the
        manifest hash comes from the same bytes."""
        plan = []
        shard_counter = 0
        for i, leaf in enumerate(leaves):
            shape = tuple(int(s) for s in leaf.shape)
            orig_dtype = _dtype_name(leaf)
            if ctx is not None and axes_leaves is not None and shape:
                entries, grid = ctx.shard_spec(axes_leaves[i], shape)
            else:
                entries, grid = ((),) * len(shape), (1,) * len(shape)
            slices = list(shard_slices(grid, shape))
            source = self._shard_source(leaf, slices, shard_counter,
                                        process_index, process_count)
            shards = []
            for j, sl in slices:
                name = _shard_name(i, j)
                sha = None
                if shard_counter % process_count == process_index:
                    arr, _ = _to_savable(source(sl))
                    buf = io.BytesIO()
                    np.save(buf, arr)
                    data = buf.getvalue()
                    sha = hashlib.sha256(data).hexdigest()
                    # write-then-rename: a shard file's existence implies it
                    # is complete, so the finalizer never hashes torn bytes
                    part = os.path.join(tmp, name + ".part")
                    with open(part, "wb") as f:
                        f.write(data)
                    os.rename(part, os.path.join(tmp, name))
                shard_counter += 1
                shards.append({"file": name, "sha256": sha})
            plan.append({"dtype": orig_dtype, "shape": list(shape),
                         "grid": list(grid),
                         "spec": [list(e) for e in entries],
                         "shards": shards})
        return plan

    @staticmethod
    def _shard_source(leaf, slices, counter0: int, process_index: int,
                      process_count: int):
        """``source(slice_tuple)`` -> the leaf's block there. A DTensor leaf
        is read from this rank's own block when every writer holds the
        blocks dealt to it (the layout matches the grid); otherwise every
        rank gathers the full value (a collective: the decision depends on
        the layout alone, so all ranks take the same branch)."""
        if not is_dtensor(leaf):
            return lambda sl: leaf[sl] if sl else leaf
        mesh = leaf.device_mesh
        ranks = mesh.mesh.reshape(-1).tolist()
        sizes = tuple(mesh.shape)
        coords = [np.unravel_index(k, sizes) for k in range(len(ranks))]
        local_ok = process_count == len(ranks) and all(
            _within(sl, _held_region(leaf, coords[(counter0 + j)
                                                  % process_count]))
            for j, sl in slices)
        if not local_ok:
            full = leaf.full_tensor()
            return lambda sl: full[sl] if sl else full
        region = _held_region(leaf, mesh.get_coordinate())
        local = leaf.to_local()

        def source(sl):
            return local[tuple(slice(s.start - r0, s.stop - r0)
                               for s, (r0, _) in zip(sl, region))]
        return source

    def _finalize(self, tmp: str, step: int, plan, ctx=None) -> str:
        """Write MANIFEST, rename into place. Shards this process staged
        carry their hash already; other writers' files are hashed from the
        shared filesystem (multi-writer only)."""
        manifest = {"format": FORMAT_VERSION, "step": int(step),
                    "num_leaves": len(plan),
                    "mesh": shlib.mesh_desc(ctx.mesh) if ctx is not None
                    else None,
                    "leaves": []}
        for entry in plan:
            shards = []
            for s in entry["shards"]:
                sha = s["sha256"]
                if sha is None:  # a peer writer's shard
                    path = os.path.join(tmp, s["file"])
                    if not os.path.isfile(path):
                        raise RuntimeError(
                            f"peer shard {s['file']} missing at finalize — "
                            "all writers must complete (barrier) before "
                            "process 0 finalizes step "
                            f"{manifest['step']}")
                    sha = _sha256(path)
                shards.append({"file": s["file"], "sha256": sha})
            manifest["leaves"].append({
                "dtype": entry["dtype"], "shape": entry["shape"],
                "grid": entry["grid"], "spec": entry["spec"],
                "shards": shards,
            })
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.dir, _STEP_FMT.format(int(step)))
        if os.path.exists(final):  # re-save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final

    def _gc(self):
        steps = self._complete_steps()
        for step in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, _STEP_FMT.format(step)),
                          ignore_errors=True)

    # -- discovery ------------------------------------------------------------

    def _complete_steps(self):
        """Ascending step numbers whose directory holds a MANIFEST."""
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_"):
                continue
            try:
                step = int(name[len("step_"):])
            except ValueError:
                continue
            if os.path.isfile(os.path.join(self.dir, name, MANIFEST)):
                out.append(step)
        return sorted(out)

    # -- restore --------------------------------------------------------------

    def _read_leaf_v2(self, d: str, entry: Dict[str, Any]) -> np.ndarray:
        """Verify + reassemble one leaf from its shard files."""
        shape = tuple(int(s) for s in entry["shape"])
        grid = tuple(int(g) for g in entry["grid"])
        if len(grid) != len(shape) or any(g < 1 for g in grid) or \
                any(s % g for s, g in zip(shape, grid)):
            raise IOError(f"manifest grid {grid} does not tile shape {shape}")
        shards = entry["shards"]
        if len(shards) != math.prod(grid):
            raise IOError(
                f"manifest lists {len(shards)} shards for grid {grid}")
        block = tuple(s // g for s, g in zip(shape, grid))
        full: Optional[np.ndarray] = None
        for (j, sl), meta in zip(shard_slices(grid, shape), shards):
            path = os.path.join(d, meta["file"])
            if not os.path.isfile(path):
                raise IOError(f"missing shard {path}")
            arr = _load_verified(path, meta["sha256"])
            if tuple(arr.shape) != block:
                raise IOError(
                    f"shard {path} has shape {arr.shape}, expected {block}")
            if full is None:
                if grid == (1,) * len(shape):
                    return arr  # unsharded fast path
                full = np.empty(shape, dtype=arr.dtype)
            full[sl] = arr
        if full is None:  # rank-0 leaf: grid == (), single shard
            raise IOError("leaf reassembly produced no data")
        return full

    def _load_step(self, template: Any, step: int, ctx=None,
                   axes: Any = None) -> Any:
        d = os.path.join(self.dir, _STEP_FMT.format(step))
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        leaves, treedef = tree_flatten(template)
        if manifest["num_leaves"] != len(leaves):
            raise TemplateMismatch(
                f"step {step}: {manifest['num_leaves']} leaves on disk, "
                f"template has {len(leaves)}")
        axes_leaves = _flatten_axes(axes, len(leaves))
        v2 = manifest.get("format", 1) >= 2
        out = []
        for i, (entry, ref) in enumerate(zip(manifest["leaves"], leaves)):
            if v2:
                arr = self._read_leaf_v2(d, entry)
            else:  # v1: one .npy per leaf, whole-file checksum
                arr = _load_verified(os.path.join(d, entry["file"]),
                                     entry["sha256"])
            ax = axes_leaves[i] if axes_leaves is not None else None
            out.append(_place_like(arr, ref, ctx, ax))
        return tree_unflatten(treedef, out)

    def restore_latest(self, template: Any, ctx=None, axes: Any = None
                       ) -> Optional[Tuple[Any, int]]:
        """(state, step) from the newest verifiable checkpoint, else None.
        The state has the template's structure (a ParamTree comes back as a
        nested dict) and each leaf its template leaf's dtype and device.

        ``ctx``/``axes`` with ``ctx.mesh`` a ``DeviceMesh``: each leaf comes
        back as a DTensor laid out on that mesh — which may differ from the
        mesh in the MANIFEST: shards are reassembled on the host and
        re-sliced, so a checkpoint of 8 ranks restores onto an elastic plan
        of 4."""
        # a malformed axes tree is a caller bug, not disk corruption — raise
        # here instead of silently skipping every checkpoint below
        _flatten_axes(axes, len(tree_flatten(template)[0]))
        for step in reversed(self._complete_steps()):
            try:
                return self._load_step(template, step, ctx, axes), step
            except TemplateMismatch:
                raise  # caller bug, not corruption — see TemplateMismatch
            except Exception:  # noqa: BLE001 - a torn step: the previous one
                continue
        return None

    def saved_mesh(self, step: Optional[int] = None) -> Optional[Dict]:
        """{axes, shape} recorded in a step's MANIFEST (newest by default)."""
        steps = self._complete_steps()
        if not steps:
            return None
        step = steps[-1] if step is None else step
        try:
            with open(os.path.join(self.dir, _STEP_FMT.format(step),
                                   MANIFEST)) as f:
                return json.load(f).get("mesh")
        except (OSError, ValueError):
            return None
