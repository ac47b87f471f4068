"""Epoched plan lifecycle: ONE owner for every device-plan build.

Counterpart of ``repro.etl.plan``.  The :class:`PlanManager` is the single
site that lowers a state's DPM and builds its device plan on the manager's
device: the fused block table for ``kind="fused"``, the same table
partitioned over a mesh's shards for ``kind="sharded"``, or the per-block
plan with every index vector resident (:func:`~repro_torch.core.dmm_torch.
place_blocks`) for ``kind="blocks"``.  One manager serves one engine kind.
Engines ask for a plan with :meth:`PlanManager.acquire` and serve the
returned :class:`PlanEpoch` lease:

  * **incremental recompaction** (the default) -- across a
    ``SchemaEvolved`` / ``MatrixEdit`` the manager diffs the DPM, re-lowers
    only the touched ``(schema, version)`` columns (:func:`~repro_torch.
    core.dmm_torch.recompile_columns`) and splices them into the previous
    epoch's table (:func:`~repro_torch.core.dmm_torch.splice_fused`), from
    the numpy table the previous build kept on the host.  ``incremental=
    False`` is the full rebuild, the bit-exactness oracle.
  * **epoch cutover without a stall** -- in-flight chunks pin the plan they
    were densified against, so epoch N drains on its own tables while N+1
    serves; no table's storage is freed or reused at a cutover.  With
    ``background=True`` a worker thread builds the next epoch as soon as the
    coordinator's eviction fan-out announces the state change; with
    ``publish=True`` each cutover is applied to the coordinator as a
    :class:`~repro_torch.etl.control.PlanPublished` control event.
  * **hot/cold residency tiering** -- per-``(o, v)`` hit counters (fed by
    ``METLApp.triage`` through :meth:`PlanManager.record_hits`) drive a
    :class:`TieringPolicy`: rarely-hit columns stay out of the device table
    as :class:`ColdColumn` leases whose index vectors live on the host, and
    a miss is mapped block by block through ``masked_gather``.
    ``bytes_resident`` prices exactly what the device holds: the resident
    table.

The epoch counter is the manager's monotone build count, not the registry
state ``i``: a residency repartition serves one state with a new epoch, and
a background build for a state that is superseded before it lands is
discarded.  ``acquire`` and the worker synchronise on one lock; a
background build whose state no longer matches, or that failed, is
replaced by the synchronous build, so the worker is an optimisation and
never a correctness dependency.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..core.dmm import DPM
from ..core.dmm_torch import (
    CompactedBlockMap,
    CompiledDMM,
    DeviceLike,
    FusedDMM,
    ShardedFusedDMM,
    compile_dpm,
    compile_fused,
    compile_fused_sharded,
    place_blocks,
    recompile_columns,
    resolve_device,
    splice_fused,
    uid_lookup_table,
)
from ..core.registry import Registry
from ..core.state import StateCoordinator, SystemState
from .control import PlanPublished

__all__ = ["PLAN_KINDS", "TieringPolicy", "ColdColumn", "PlanEpoch", "PlanManager"]

PLAN_KINDS = ("fused", "sharded", "blocks")

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class TieringPolicy:
    """Residency policy: which columns get device-table rows.

    A column is cold when its cumulative triage hits are below
    ``min_hits``, except that with ``pin_latest=True`` the latest live
    version of every schema stays resident, so the first chunk after an
    evolution never misses.  Residency is decided at build time (a state
    change or :meth:`PlanManager.repartition`), never mid-epoch."""

    min_hits: int = 1
    pin_latest: bool = True

    def cold_columns(
        self, compiled: CompiledDMM, registry: Registry, hits: Dict[Tuple[int, int], int]
    ) -> Set[Tuple[int, int]]:
        cold: Set[Tuple[int, int]] = set()
        for o, v in compiled.by_column:
            if hits.get((o, v), 0) >= self.min_hits:
                continue
            if (self.pin_latest and registry.domain.has(o, v)
                    and v == registry.domain.latest_version(o)):
                continue
            cold.add((o, v))
        return cold


@dataclasses.dataclass
class ColdColumn:
    """One column kept out of the device table: what a tier miss needs to
    densify the column at its true width (``lut``) and map it block by
    block.  The blocks' index vectors stay on the host, concatenated in
    ``src_flat`` as :func:`~repro_torch.core.dmm_torch.place_blocks` lays
    them out; each block's ``src`` is a view of it."""

    o: int
    v: int
    n_in: int
    lut: np.ndarray  # uid -> payload slot (dense, -1 = foreign)
    blocks: List[CompactedBlockMap]
    src_flat: np.ndarray  # int32: every block's src, end to end


def _cold_column(ov: Tuple[int, int], blocks: List[CompactedBlockMap],
                 registry: Registry) -> ColdColumn:
    flat = (np.concatenate([b.src for b in blocks]) if blocks
            else np.empty(0, dtype=np.int32))
    views, off = [], 0
    for b in blocks:
        views.append(dataclasses.replace(b, src=flat[off : off + b.n_out_pad]))
        off += b.n_out_pad
    uids = registry.domain.get(*ov).uids
    return ColdColumn(o=ov[0], v=ov[1], n_in=len(uids), lut=uid_lookup_table(uids),
                      blocks=views, src_flat=flat)


@dataclasses.dataclass(frozen=True)
class PlanEpoch:
    """One published plan epoch: the immutable lease an engine serves.

    ``plan`` is the device plan for the engine kind (a :class:`FusedDMM`, a
    :class:`ShardedFusedDMM`, or for the per-block engine the placed
    :class:`CompiledDMM`) covering the resident columns; ``compiled`` is
    the host lowering of every column, hot or cold; ``cold`` holds the
    columns kept out.  ``touched_columns`` counts the columns an
    incremental build re-lowered (every column for a full build)."""

    epoch: int
    state: int
    compiled: CompiledDMM
    plan: Union[FusedDMM, ShardedFusedDMM, CompiledDMM]
    cold: Dict[Tuple[int, int], ColdColumn]
    bytes_resident: int
    incremental: bool
    touched_columns: int
    rebuild_s: float


def _resident_compiled(compiled: CompiledDMM, cold: Set[Tuple[int, int]]) -> CompiledDMM:
    """The hot columns' view the device table is built from."""
    if not cold:
        return compiled
    return CompiledDMM(
        state=compiled.state,
        by_column={ov: b for ov, b in compiled.by_column.items() if ov not in cold},
    )


def _bytes_resident(plan: Union[FusedDMM, ShardedFusedDMM, CompiledDMM]) -> int:
    """Device-resident block-table bytes of one plan."""
    if isinstance(plan, ShardedFusedDMM):
        return plan.table_bytes
    if isinstance(plan, FusedDMM):
        return int(plan.src2d.nbytes)
    return plan.src_bytes  # the per-block plan: every index vector resident


def _touched(old_dpm: DPM, new_dpm: DPM) -> Set[Tuple[int, int]]:
    """Incoming columns whose mapping paths changed between two DPMs.
    Snapshots share element containers with the coordinator's DPM (a
    shallow copy; the Algorithm-5 update builds new containers for the keys
    it changes), so unchanged entries pass on the identity test."""
    touched = {(key[0], key[1]) for key in old_dpm.keys() ^ new_dpm.keys()}
    for key in old_dpm.keys() & new_dpm.keys():
        a, b = old_dpm[key], new_dpm[key]
        if a is not b and a != b:
            touched.add((key[0], key[1]))
    return touched


class PlanManager:
    """Epoch-versioned owner of plan builds of one ``kind`` for one device
    (see the module docstring).

    ``kind="sharded"`` needs a ``mesh`` (:func:`repro_torch.launch.mesh.
    make_etl_mesh`; its first device is the manager's).  ``background=True``
    needs the ``coordinator`` whose evictions announce a state change;
    ``publish=True`` without one publishes nothing.  ``tiering`` applies to
    the fused and sharded kinds; the per-block plan keeps every column."""

    def __init__(
        self,
        *,
        kind: str = "fused",
        device: Optional[DeviceLike] = None,
        mesh: Any = None,
        coordinator: Optional[StateCoordinator] = None,
        incremental: bool = True,
        background: bool = False,
        publish: bool = False,
        tiering: Optional[TieringPolicy] = None,
    ) -> None:
        if kind not in PLAN_KINDS:
            raise ValueError(f"unknown plan kind {kind!r} (ported: {PLAN_KINDS})")
        if kind == "sharded" and mesh is None:
            raise ValueError("kind='sharded' needs a mesh")
        if background and coordinator is None:
            raise ValueError("background=True needs a coordinator")
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
        self.coordinator = coordinator
        self.incremental = incremental
        self.publish = publish and coordinator is not None
        self.tiering = tiering
        self._lock = threading.Lock()
        self._lease: Optional[PlanEpoch] = None
        # the serving lease and the DPM it was built from: the base of the
        # next splice
        self._base: Optional[Tuple[PlanEpoch, DPM]] = None
        self._hits: Dict[Tuple[int, int], int] = {}
        self._epoch = 0
        self.rebuilds = 0
        self.incremental_rebuilds = 0
        self.last_rebuild_s = 0.0
        self.total_rebuild_s = 0.0
        self._pool: Optional[ThreadPoolExecutor] = None
        self._prepared: Optional[Future] = None
        if background:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="plan-recompactor")
            # the eviction fan-out announces the state change: start the
            # next epoch's build while the current one keeps serving (weak:
            # the coordinator must not keep a dropped manager alive)
            coordinator.on_evict(self._on_coordinator_evict, weak=True)

    # -- plan acquisition (the engines' single entry point) -----------------
    def acquire(self, snapshot: SystemState, registry: Registry) -> PlanEpoch:
        """The lease for ``snapshot``'s state: cached when current, adopted
        from the background build when it prepared this state, built
        (incrementally when possible) otherwise."""
        with self._lock:
            if self._lease is not None and self._lease.state == snapshot.i:
                return self._lease
            lease = self._take_prepared(snapshot.i)
            if lease is None:
                lease = self._build(snapshot, registry, self._base, dict(self._hits))
            return self._install(lease, snapshot.dpm)

    def repartition(self, snapshot: SystemState, registry: Registry) -> PlanEpoch:
        """Rebuild at the same state so the residency policy sees the hits
        counted since the serving epoch was cut (a new epoch, same ``i``)."""
        with self._lock:
            lease = self._build(snapshot, registry, self._base, dict(self._hits))
            return self._install(lease, snapshot.dpm)

    def invalidate(self) -> None:
        """Drop the cached lease (the next acquire rebuilds in full)."""
        with self._lock:
            self._lease = None
            self._base = None

    def close(self) -> None:
        """Stop the background worker (no-op without one)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- tier hit accounting -------------------------------------------------
    def record_hits(self, by_column) -> None:
        """Add one triaged chunk's per-``(o, v)`` event counts to the
        residency counters: a triage ``by_column`` mapping (values sized)
        or any ``(key, count)`` iterable."""
        items = by_column.items() if hasattr(by_column, "items") else by_column
        with self._lock:
            for ov, val in items:
                n = int(val.size if hasattr(val, "size") else val)
                if n:
                    self._hits[ov] = self._hits.get(ov, 0) + n

    # -- observability -------------------------------------------------------
    def info(self) -> Dict[str, Any]:
        """``plan_epoch``, ``rebuilds``, ``incremental_rebuilds``, rebuild
        timings and, once a plan exists, ``bytes_resident`` and
        ``cold_columns``."""
        with self._lock:
            lease = self._lease
            d: Dict[str, Any] = {
                "plan_epoch": lease.epoch if lease is not None else 0,
                "rebuilds": self.rebuilds,
                "incremental_rebuilds": self.incremental_rebuilds,
                "last_rebuild_s": self.last_rebuild_s,
                "total_rebuild_s": self.total_rebuild_s,
            }
            if lease is not None:
                d["bytes_resident"] = lease.bytes_resident
                d["cold_columns"] = len(lease.cold)
            return d

    # -- build internals -----------------------------------------------------
    def _on_coordinator_evict(self, i: int) -> None:
        # on the control thread, after the state bump: build the next epoch
        # while the current one keeps serving
        if self._pool is None:
            return
        snap = self.coordinator.snapshot()
        registry = self.coordinator.registry
        with self._lock:
            self._prepared = self._pool.submit(self._build, snap, registry, self._base,
                                               dict(self._hits))

    def _take_prepared(self, state: int) -> Optional[PlanEpoch]:
        # lock held: adopt the background build only if it is for this
        # state; a stale or failed build is dropped (the sync build covers it)
        fut, self._prepared = self._prepared, None
        if fut is None:
            return None
        try:
            lease = fut.result()
        except Exception:
            _log.warning("background plan build failed; building synchronously",
                         exc_info=True)
            return None
        return lease if lease.state == state else None

    def _install(self, lease: PlanEpoch, dpm: DPM) -> PlanEpoch:
        # lock held
        self._epoch += 1
        lease = dataclasses.replace(lease, epoch=self._epoch)
        self._lease = lease
        self._base = (lease, dict(dpm))
        self.rebuilds += 1
        if lease.incremental:
            self.incremental_rebuilds += 1
        self.last_rebuild_s = lease.rebuild_s
        self.total_rebuild_s += lease.rebuild_s
        if self.publish and self.coordinator.is_control_writer:
            # a "plan" event bumps and evicts nothing, so this re-enters no
            # hook; a follower replica publishes nothing (its log carries
            # only the leader's records)
            self.coordinator.apply(PlanPublished(  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                epoch=lease.epoch,
                state=lease.state,
                kind=self.kind,
                incremental=lease.incremental,
                touched_columns=lease.touched_columns,
                n_blocks=lease.compiled.n_blocks,
                bytes_resident=lease.bytes_resident,
                rebuild_s=lease.rebuild_s,
            ))
        return lease

    def _device_scope(self):
        """The manager's card as the current device (the worker thread's
        default is card 0); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _build(
        self,
        snapshot: SystemState,
        registry: Registry,
        base: Optional[Tuple[PlanEpoch, DPM]],
        hits: Dict[Tuple[int, int], int],
    ) -> PlanEpoch:
        """One epoch's build from ``base`` (the serving lease and its DPM,
        taken under the lock with the hit counts): incremental when there
        is one, full otherwise.  Runs on the caller's thread or the
        worker's.  Every upload is a blocking copy from pageable memory, so
        the tables are on the device when this returns and a lease is never
        installed ahead of its uploads."""
        t0 = time.perf_counter()
        touched: Optional[FrozenSet[Tuple[int, int]]] = None
        if self.incremental and base is not None:
            old, old_dpm = base
            touched = frozenset(_touched(old_dpm, snapshot.dpm))
            compiled = recompile_columns(  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                old.compiled, snapshot.dpm, registry, touched)
        else:
            compiled = compile_dpm(snapshot.dpm, registry)

        cold_set: Set[Tuple[int, int]] = set()
        if self.tiering is not None and self.kind != "blocks":
            cold_set = self.tiering.cold_columns(compiled, registry, hits)
        resident = _resident_compiled(compiled, cold_set)

        plan: Union[FusedDMM, ShardedFusedDMM, CompiledDMM]
        with self._device_scope():
            if self.kind == "blocks":
                plan = place_blocks(compiled, self.device)
            elif touched is not None:
                plan = splice_fused(  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                    old.plan, resident, registry, touched)
            elif self.kind == "sharded":
                plan = compile_fused_sharded(  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                    resident, registry, mesh=self.mesh)
            else:
                plan = compile_fused(  # metl: allow[plan-publish-single-site] this IS the port's plan manager, the counterpart of repro.etl.plan; the rule's owner list names only the reference modules
                    resident, registry, device=self.device)
        cold = {ov: _cold_column(ov, compiled.by_column[ov], registry)
                for ov in sorted(cold_set)}
        return PlanEpoch(
            epoch=0,  # assigned at install, under the lock
            state=snapshot.i,
            compiled=compiled,
            plan=plan,
            cold=cold,
            bytes_resident=_bytes_resident(plan),
            incremental=touched is not None,
            touched_columns=len(touched) if touched is not None else len(compiled.by_column),
            rebuild_s=time.perf_counter() - t0,
        )
