"""Epoched plan lifecycle: ONE owner for every device-plan build.

Counterpart of ``repro.etl.plan``, first cut: the :class:`PlanManager` is the
single site that lowers a state's DPM (:func:`~repro_torch.core.dmm_torch.
compile_dpm`) and builds its device plan on the manager's device: the fused
block table (:func:`~repro_torch.core.dmm_torch.compile_fused`) for
``kind="fused"``, the same table partitioned over a mesh's shards
(:func:`~repro_torch.core.dmm_torch.compile_fused_sharded`) for
``kind="sharded"``, or the per-block plan with every index vector resident
(:func:`~repro_torch.core.dmm_torch.place_blocks`) for ``kind="blocks"``.
One manager serves one engine kind.  Engines ask for a plan
with :meth:`PlanManager.acquire` and serve the returned :class:`PlanEpoch`
lease; in-flight chunks pin the plan they were densified against, so an
epoch keeps serving its drains after the manager moves on.

Every build is a full rebuild.  The reference's incremental splice,
residency tiering, background recompactor and ``PlanPublished`` events are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Union

from ..core.dmm_torch import (
    CompiledDMM,
    DeviceLike,
    FusedDMM,
    ShardedFusedDMM,
    compile_dpm,
    compile_fused,
    compile_fused_sharded,
    place_blocks,
    resolve_device,
)
from ..core.registry import Registry
from ..core.state import SystemState

__all__ = ["PLAN_KINDS", "PlanEpoch", "PlanManager"]

PLAN_KINDS = ("fused", "sharded", "blocks")


@dataclasses.dataclass(frozen=True)
class PlanEpoch:
    """One published plan epoch: the immutable lease an engine serves.

    ``plan`` is the device plan (a :class:`FusedDMM`, a
    :class:`ShardedFusedDMM`, or for the per-block engine the placed
    :class:`CompiledDMM`), ``compiled`` the host lowering
    it was built from; ``bytes_resident`` prices the device-resident block
    table or index vectors."""

    epoch: int
    state: int
    compiled: CompiledDMM
    plan: Union[FusedDMM, ShardedFusedDMM, CompiledDMM]
    bytes_resident: int
    rebuild_s: float


class PlanManager:
    """Epoch-versioned owner of plan builds of one ``kind`` for one device.

    ``kind="sharded"`` needs a ``mesh`` (:func:`repro_torch.launch.mesh.
    make_etl_mesh`; its first device is the manager's)."""

    def __init__(
        self,
        *,
        kind: str = "fused",
        device: Optional[DeviceLike] = None,
        mesh: Any = None,
    ) -> None:
        if kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {kind!r} (ported: {PLAN_KINDS})")
        if kind == "sharded" and mesh is None:
            raise ValueError("kind='sharded' needs a mesh")
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.devices[0]:
                raise ValueError(
                    f"device={device!r} conflicts with the mesh's first device "
                    f"{mesh.devices[0]}"
                )
            device = mesh.devices[0]
        self.kind = kind
        self.mesh = mesh
        self.device = resolve_device("cuda" if device is None else device)
        self._lock = threading.Lock()
        self._lease: Optional[PlanEpoch] = None
        self._epoch = 0
        self.rebuilds = 0
        self.last_rebuild_s = 0.0
        self.total_rebuild_s = 0.0

    def acquire(self, snapshot: SystemState, registry: Registry) -> PlanEpoch:
        """The lease for ``snapshot``'s state: cached when current, rebuilt
        otherwise."""
        with self._lock:
            if self._lease is not None and self._lease.state == snapshot.i:
                return self._lease
            t0 = time.perf_counter()
            compiled = compile_dpm(snapshot.dpm, registry)
            plan: Union[FusedDMM, ShardedFusedDMM, CompiledDMM]
            if self.kind == "blocks":
                plan = place_blocks(compiled, self.device)
                bytes_resident = plan.src_bytes
            elif self.kind == "sharded":
                plan = compile_fused_sharded(  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                    compiled, registry, mesh=self.mesh,
                )
                bytes_resident = plan.table_bytes
            else:
                plan = compile_fused(compiled, registry, device=self.device)  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                bytes_resident = int(plan.src2d.nbytes)
            rebuild_s = time.perf_counter() - t0
            self._epoch += 1
            self._lease = PlanEpoch(
                epoch=self._epoch,
                state=snapshot.i,
                compiled=compiled,
                plan=plan,
                bytes_resident=bytes_resident,
                rebuild_s=rebuild_s,
            )
            self.rebuilds += 1
            self.last_rebuild_s = rebuild_s
            self.total_rebuild_s += rebuild_s
            return self._lease

    def info(self) -> Dict[str, Any]:
        """``plan_epoch``, ``rebuilds``, rebuild timings and, once a plan
        exists, ``bytes_resident``."""
        with self._lock:
            lease = self._lease
            d: Dict[str, Any] = {
                "plan_epoch": lease.epoch if lease is not None else 0,
                "rebuilds": self.rebuilds,
                "last_rebuild_s": self.last_rebuild_s,
                "total_rebuild_s": self.total_rebuild_s,
            }
            if lease is not None:
                d["bytes_resident"] = lease.bytes_resident
            return d
