#!/usr/bin/env python3
"""Which collectives of the model mesh run on ONE card shared by four
processes in a gloo group (NCCL refuses two ranks on one card).

    python3 scripts/mesh_probe.py

Each probe runs in its own spawn of four ranks on ``cuda:0`` (a crash in
one cannot hide the others) and prints ``ok``, ``WRONG`` (a wrong result),
``FAIL`` (an exception) or the ranks' exit codes.  The probes:
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` (float32,
bfloat16), ``all_reduce`` (SUM int32, MAX float32), ``all_to_all_single``
(float32, bfloat16), each on CUDA tensors with values exact in their
dtype, and DTensor's own ``redistribute`` of a (2, 2)-sharded leaf to
replicated with a backward (the route ``repro_torch/sharding/comm.py``
does not take).  Needs a CUDA device.
"""

import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _probe(name, rank):
    dev = torch.device("cuda:0")
    if name.startswith("dtensor"):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        full = torch.arange(16 * 8, dtype=torch.float32, device=dev).reshape(16, 8)
        d, m = mesh.get_coordinate()
        w = DTensor.from_local(full.chunk(2, 0)[d].chunk(2, 1)[m].clone(), mesh,
                               [Shard(0), Shard(1)], run_check=False).requires_grad_(True)
        g = w.redistribute(mesh, [Replicate(), Replicate()]).to_local(
            grad_placements=[Partial(), Replicate()])
        g.sum().backward()
        return bool((g == full).all()) and bool((w.grad.to_local() == 2).all())
    kind, dtype = name.rsplit(" ", 1)
    dt = getattr(torch, dtype)
    if kind == "all_gather_into_tensor":
        out = torch.empty((4 * WORLD, 3), dtype=dt, device=dev)
        dist.all_gather_into_tensor(out, torch.full((4, 3), float(rank), dtype=dt, device=dev))
        return bool((out[::4, 0].float().cpu() == torch.arange(WORLD).float()).all())
    if kind == "reduce_scatter_tensor":
        out = torch.empty((4, 3), dtype=dt, device=dev)
        dist.reduce_scatter_tensor(out, torch.full((4 * WORLD, 3), rank + 1.0, dtype=dt,
                                                   device=dev))
        return bool((out.float().cpu() == WORLD * (WORLD + 1) / 2).all())
    if kind == "all_reduce_sum":
        x = torch.full((5,), rank + 1, dtype=dt, device=dev)
        dist.all_reduce(x)
        return bool((x.cpu() == WORLD * (WORLD + 1) // 2).all())
    if kind == "all_reduce_max":
        x = torch.full((5,), float(rank), dtype=dt, device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return bool((x.float().cpu() == WORLD - 1).all())
    x = (torch.arange(2 * WORLD, device=dev) + 16 * rank).to(dt)  # exact in bfloat16
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    want = torch.tensor([16 * j + 2 * rank + i for j in range(WORLD) for i in range(2)])
    return bool((out.float().cpu() == want.float()).all())


def _rank(rank, port, name, queue):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        res = "ok" if _probe(name, rank) else "WRONG"
    except Exception as err:  # the probe's finding, reported
        res = f"FAIL {type(err).__name__}: {str(err).splitlines()[0][:120]}"
    queue.put((rank, res))
    dist.barrier()
    dist.destroy_process_group()


PROBES = ["all_gather_into_tensor float32", "all_gather_into_tensor bfloat16",
          "reduce_scatter_tensor float32", "reduce_scatter_tensor bfloat16",
          "all_reduce_sum int32", "all_reduce_max float32", "all_to_all_single float32",
          "all_to_all_single bfloat16", "dtensor redistribute float32"]


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_probe: needs a CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    for name in PROBES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        queue = ctx.SimpleQueue()
        procs = [ctx.Process(target=_rank, args=(r, port, name, queue)) for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
            if p.is_alive():
                p.terminate()
        results = {}
        while not queue.empty():
            rank, res = queue.get()
            results[rank] = res
        codes = [p.exitcode for p in procs]
        print(f"{name}: {sorted(set(results.values())) or 'no result'} exit codes {codes}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
