"""Device layout of the sharded mapping engine.

Counterpart of ``repro.launch.mesh.make_etl_mesh`` and of the placement
``repro.sharding.specs.dmm_table_sharding`` gives the sharded block table:
a 1 x N layout whose ``data`` axis holds the table's shards, shard ``s`` on
``devices[s]``.  PyTorch has no mesh, so :class:`ETLMesh` is an explicit
device list.  A device may appear more than once: ``["cuda:0"] * 4`` runs
four shards on one card, ``["cpu"] * 4`` four on the CPU.  That is the
port's form of the reference's forced host device count.  The devices are
all CUDA devices or all the CPU.  Shards that share a device must be
adjacent in the list; their tables are stacked into one tensor on that
device and mapped by one kernel launch.  No ``torch.distributed``: every
device is driven from this process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.dmm_torch import DeviceLike, resolve_device

__all__ = ["ETLMesh", "make_etl_mesh"]


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
