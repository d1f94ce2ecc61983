"""Which collectives gloo carries for CUDA tensors, two ranks sharing one
card (NCCL refuses two ranks of one communicator on one GPU).

Each collective that the mesh training path hands to
``torch.distributed``, and a DTensor redistribute on a CUDA ``DeviceMesh``
over gloo, runs in a pair of fresh processes (a FileStore rendezvous in a
temporary directory) with its tensors on ``cuda:0``, so that a rank that
dies takes no other op with it. Prints each op's outcome, "ok" (and
whether the result is right) or the error text, then one JSON object of
all.

  python benchmarks/torch_gloo_cuda_probe.py
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile


OPS = ("all_gather_int8", "all_gather_f32", "all_to_all_int8",
       "all_reduce_max", "all_reduce_sum", "barrier", "new_group_all_gather",
       "functional_all_gather", "device_mesh_only", "dtensor_from_local",
       "dtensor_gloo_override", "dtensor_redistribute")


def _ops(rank):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    w = dist.get_world_size()

    def all_gather_int8():
        x = torch.full((8,), rank + 1, dtype=torch.int8, device=dev)
        out = torch.empty(w * 8, dtype=torch.int8, device=dev)
        dist.all_gather_into_tensor(out, x)
        return bool((out.view(w, 8)[:, 0].cpu()
                     == torch.arange(1, w + 1, dtype=torch.int8)).all())

    def all_gather_f32():
        x = torch.full((1,), float(rank), device=dev)
        out = torch.empty(w, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out.cpu().tolist() == [float(r) for r in range(w)]

    def all_to_all_int8():
        x = torch.arange(w * 4, dtype=torch.int8, device=dev) + 10 * rank
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = torch.cat([torch.arange(rank * 4, rank * 4 + 4) + 10 * r
                          for r in range(w)]).to(torch.int8)
        return bool(torch.equal(out.cpu(), want))

    def all_reduce_max():
        x = torch.tensor([float(rank)], device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x) == float(w - 1)

    def all_reduce_sum():
        x = torch.tensor([1.0], device=dev)
        dist.all_reduce(x)
        return float(x) == float(w)

    def barrier():
        dist.barrier()
        return True

    def dtensor_redistribute():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, Shard, \
            distribute_tensor
        mesh = init_device_mesh("cuda", (w,), mesh_dim_names=("data",))
        full = torch.arange(8.0, device=dev)
        d = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None) \
            if "src_data_rank" in distribute_tensor.__code__.co_varnames \
            else distribute_tensor(full, mesh, [Shard(0)])
        return bool(torch.equal(d.redistribute(mesh, [Replicate()])
                                .to_local(), full))

    def new_group_all_gather():
        g = dist.new_group([0, 1])
        x = torch.full((4,), float(rank), device=dev)
        out = torch.empty(w * 4, device=dev)
        dist.all_gather_into_tensor(out, x, group=g)
        return out.view(w, 4)[:, 0].cpu().tolist() == [0.0, 1.0]

    def functional_all_gather():
        from torch.distributed import _functional_collectives as fc
        x = torch.full((4,), float(rank), device=dev)
        out = fc.all_gather_tensor(x, 0, dist.group.WORLD)
        return out.view(w, 4)[:, 0].cpu().tolist() == [0.0, 1.0]

    def device_mesh_only():
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh("cuda", torch.arange(w), mesh_dim_names=("data",))
        return mesh.get_coordinate() == [rank]

    def _from_local(mesh):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        full = torch.arange(8.0, device=dev)
        d = DTensor.from_local(full[rank * 4:rank * 4 + 4], mesh, [Shard(0)],
                               run_check=False)
        return bool(torch.equal(d.redistribute(mesh, [Replicate()])
                                .to_local(), full))

    def dtensor_from_local():
        from torch.distributed.device_mesh import DeviceMesh
        return _from_local(DeviceMesh("cuda", torch.arange(w),
                                      mesh_dim_names=("data",)))

    def dtensor_gloo_override():
        from torch.distributed.device_mesh import init_device_mesh
        return _from_local(init_device_mesh(
            "cuda", (w,), mesh_dim_names=("data",),
            backend_override={"data": "gloo"}))

    return {f.__name__: f for f in (
        all_gather_int8, all_gather_f32, all_to_all_int8, all_reduce_max,
        all_reduce_sum, barrier, new_group_all_gather, functional_all_gather,
        device_mesh_only, dtensor_from_local, dtensor_gloo_override,
        dtensor_redistribute)}


def _rank(rank, world, tmp, name):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, f"store_{name}"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        out = {"ok": True, "right": _ops(rank)[name]()}
    except Exception as e:  # noqa: BLE001 - the probe records each
        out = {"ok": False, "error": f"{type(e).__name__}: "
               f"{str(e).splitlines()[0][:300]}"}
    if rank == 0:
        with open(os.path.join(tmp, f"{name}.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def main():
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="gloo_cuda_probe_")
    out = {}
    for name in OPS:  # each op in a pair of fresh processes
        try:
            mp.start_processes(_rank, args=(2, tmp, name), nprocs=2,
                               start_method="spawn")
            with open(os.path.join(tmp, f"{name}.json")) as f:
                out[name] = json.load(f)
        except Exception as e:  # noqa: BLE001 - a rank died (a signal)
            out[name] = {"ok": False, "error": f"{type(e).__name__}: "
                         f"{str(e).strip().splitlines()[-1][:300]}"}
        print(name, out[name], flush=True)
    print(json.dumps({"torch": torch.__version__, "gloo_cuda": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
