"""Device layouts: the model mesh and the sharded mapping engine's.

The model mesh (counterpart of ``repro.launch.mesh.make_local_mesh`` and
``make_production_mesh``) is a ``torch.distributed`` :class:`DeviceMesh`
with axes ``("data", "model")`` (``("pod", "data", "model")`` for the
multi-pod shape), one process a device.  :func:`run_on_mesh` sets the
processes up: it joins the group of a launcher such as ``torchrun``
(``RANK`` and ``WORLD_SIZE`` in the environment) or spawns ``data * model``
local processes, builds the mesh in each and runs a function there.  On
the card the group speaks NCCL, rank ``r`` on ``cuda:(r % device_count)``;
on the CPU (``device="cpu"``) it speaks gloo.

The sharded mapping engine's layout is :class:`ETLMesh`, counterpart of
``repro.launch.mesh.make_etl_mesh`` and of the placement
``repro.sharding.specs.dmm_table_sharding`` gives the sharded block table:
a 1 x N layout whose ``data`` axis holds the table's shards, shard ``s`` on
``devices[s]``.  The engine drives its shards from one process, so
:class:`ETLMesh` is an explicit device list, not a process mesh.  A
device may appear more than once: ``["cuda:0"] * 4`` runs four shards on
one card, ``["cpu"] * 4`` four on the CPU.  That is the
port's form of the reference's forced host device count.  The devices are
all CUDA devices or all the CPU.  Shards that share a device must be
adjacent in the list; their tables are stacked into one tensor on that
device and mapped by one kernel launch.  No ``torch.distributed``: every
device is driven from this process.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.dmm_torch import DeviceLike, resolve_device

__all__ = ["ETLMesh", "make_etl_mesh", "make_local_mesh", "make_production_mesh",
           "run_on_mesh"]


# ---------------------------------------------------------------------------
# The model mesh
# ---------------------------------------------------------------------------


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: DeviceLike, message: str):
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    size = 1
    for s in shape:
        size *= s
    if size > n:
        raise ValueError(message.format(need=size, have=n))
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a model mesh needs a torch.distributed process group: build it "
                           "inside run_on_mesh(...) or under torchrun")
    return DeviceMesh(dev.type, torch.arange(size).reshape(shape), mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *, device: DeviceLike = "cuda"):
    """A (data, model) mesh over ranks ``0 .. data*model - 1`` of the
    process group, for tensors on ``device`` (the card by default; raises
    without one).  Raises ``need N devices, have M`` when the group has
    fewer ranks, as the reference does with too few devices."""
    return _mesh((data, model), ("data", "model"), device, "need {need} devices, have {have}")


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = "cuda"):
    """The production shape: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model"); ``model`` is the TP/EP axis, ``pod``
    the pure data-parallel axis folded into the data-parallel group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device,
                 "Number of devices {have} must be >= the product of mesh_shape " + str(shape))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _set_rank_device(device: DeviceLike, rank: int) -> DeviceLike:
    if torch.device(device).type != "cuda":
        return device
    resolve_device("cuda")  # raises without a card
    index = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return f"cuda:{index}"


def _rank_main(rank, world, port, backend, device, shape, fn, args, queue):
    try:
        if torch.device(device).type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = _set_rank_device(device, rank)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        mesh = make_local_mesh(*shape, device=dev)
        out = fn(mesh, *args)
        dist.barrier()
        queue.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which stops every rank and raises
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_on_mesh(fn: Callable, data: int = 1, model: int = 1, *, device: DeviceLike = "cuda",
                backend: Optional[str] = None, args: Sequence = (),
                timeout: float = 1800.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a (data, model) mesh and
    return the ranks' results.

    Under a launcher that set ``RANK`` and ``WORLD_SIZE`` (``torchrun``),
    this process joins its group (``env://``) and the result is this
    rank's alone, a list of one.  Otherwise ``data * model`` processes are
    spawned (never forked: CUDA does not survive a fork), each joins a group
    at ``tcp://localhost:<free port>``, and the results come back in rank
    order; ``fn`` and ``args`` must pickle (a module-level function).  A
    rank that raises or dies stops the others, and this raises with its
    traceback.  ``backend``: NCCL on the card, gloo on the CPU, unless
    given.  A spawned CPU rank takes its share of the host's cores."""
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if torch.device(device).type == "cuda":
        resolve_device("cuda")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        dev = _set_rank_device(device, rank)
        own = not dist.is_initialized()
        if own:
            dist.init_process_group(backend, init_method="env://")
        try:
            return [fn(make_local_mesh(data, model, device=dev), *args)]
        finally:
            if own:
                dist.destroy_process_group()
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    world = data * model
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, backend, device,
                                                  (data, model), fn, tuple(args), queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and error is None:
            if not queue.empty():
                rank, ok, out = queue.get()
                if ok:
                    results[rank] = out
                else:
                    error = f"rank {rank} of {world} failed:\n{out}"
            elif any(p.exitcode not in (None, 0) for p in procs):
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if queue.empty():
                    error = f"ranks {dead} of {world} died (exit codes " \
                            f"{[procs[r].exitcode for r in dead]})"
            elif time.monotonic() > deadline:
                error = f"the {world} ranks did not finish within {timeout} s"
            else:
                time.sleep(0.02)
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(world)]



@dataclasses.dataclass(frozen=True)
class ETLMesh:
    """Shard ``s`` of the sharded engine lives on ``devices[s]``."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": 1}

    @property
    def groups(self) -> Tuple[Tuple[torch.device, int, int], ...]:
        """``(device, lo, hi)`` per distinct device, in order: shards
        ``[lo, hi)`` live on ``device``."""
        out = []
        lo = 0
        for s in range(1, len(self.devices) + 1):
            if s == len(self.devices) or self.devices[s] != self.devices[lo]:
                out.append((self.devices[lo], lo, s))
                lo = s
        return tuple(out)


def make_etl_mesh(shards: int = 0, devices: Optional[Sequence[DeviceLike]] = None) -> ETLMesh:
    """1 x N layout for ``engine="sharded"``.

    ``devices=None`` takes every CUDA device (and raises without one);
    ``shards=0`` puts one shard on each device of the list, ``shards=n``
    the first ``n``.  Asking for more shards than devices raises, as in
    the reference; so does a device that reappears after another, and a
    list that mixes device types."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_etl_mesh() takes the CUDA devices, but "
                "torch.cuda.is_available() is False; pass devices=['cpu'] * n "
                "to shard on the CPU"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    n = len(devs)
    shards = shards or n
    if shards > n:
        raise ValueError(f"need {shards} devices for {shards} shards, have {n}")
    mesh = ETLMesh(devices=devs[:shards])
    if len({d for d, _, _ in mesh.groups}) != len(mesh.groups):
        raise ValueError(
            f"shards that share a device must be adjacent: {[str(d) for d in mesh.devices]}"
        )
    # one type: a mesh over the card runs only kernels, one over the CPU only
    # the plain versions; a mixed list would move card tensors to the CPU
    types = {d.type for d in mesh.devices}
    if types not in ({"cuda"}, {"cpu"}):
        raise ValueError(
            f"a mesh's devices must be all 'cuda' or all 'cpu': {[str(d) for d in mesh.devices]}"
        )
    return mesh
