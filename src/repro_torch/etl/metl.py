"""The METL app: consume CDC events, map them to the CDM, emit canonical rows.

Counterpart of ``repro.etl.metl``.  :class:`METLApp` is the stream-side
facade: it owns every per-event responsibility -- state sync (paper SS3.4:
stale events raise in strict mode, or park / dead-letter), at-least-once
dedup over a sliding key window, parked-event replay after a refresh, and
dead-letter offset reset -- and exposes them as :meth:`METLApp.triage`.  The
mapping itself lives behind the engine (:mod:`repro_torch.etl.engines`):
``consume`` is ``triage -> engine.consume_groups`` -- densify, dispatch (one
per chunk on the fused engine, one per block on the per-block engine), emit.

The app runs on the card by default (``device="cuda"``) and raises when no
CUDA device exists; ``device="cpu"`` runs the same path through the plain
PyTorch versions of the kernels.  ``plan_manager`` binds an explicit
:class:`~repro_torch.etl.plan.PlanManager` (residency tiering, a background
build, published epochs); without one the engine builds its own, which
splices each schema change incrementally, as the reference's does.
``engine.info()`` is the observability surface; :meth:`METLApp.
consume_scalar` is the paper's Algorithm 6, one message at a time, kept as
the oracle of the engines.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

from ..core.dmm import Message, map_message_dense
from ..core.dmm_torch import DeviceLike
from ..core.registry import StaleStateError
from ..core.state import StateCoordinator, SystemState
from .engines import CanonicalRow, MappingEngine, TriagedChunk, make_engine
from .events import CDCEvent, ColumnarChunk, columnarize
from .plan import PlanManager

__all__ = ["METLApp", "CanonicalRow"]


class METLApp:
    """One horizontally-scaled METL instance (triage facade + engine).

    ``engine`` is a registered name (built on ``device``, which defaults to
    ``"cuda"``) or an engine instance (adopted on its own device).  ``impl``
    picks the per-block mapping algorithm: ``"gather"`` (the compacted DMM)
    or ``"onehot"`` (the matrix-operator baseline, which routes
    ``engine="fused"`` to the per-block engine; see :func:`make_engine`).
    ``engine="sharded"`` partitions the block table over ``mesh``
    (:func:`repro_torch.launch.mesh.make_etl_mesh`; one shard or no mesh
    runs the fused engine).  ``plan_manager`` is passed to
    :func:`~repro_torch.etl.engines.make_engine`: its kind, device and mesh
    must be the engine's, and with ``device`` unset the engine takes the
    manager's device.
    """

    def __init__(
        self,
        coordinator: StateCoordinator,
        *,
        strict_state: bool = False,
        dedup_window: int = 4096,
        engine: Union[str, MappingEngine] = "fused",
        impl: str = "gather",
        device: Optional[DeviceLike] = None,
        mesh: Any = None,
        device_densify: bool = False,
        plan_manager: Optional[PlanManager] = None,
    ) -> None:
        self.coordinator = coordinator
        self.strict_state = strict_state
        self.mesh = mesh
        self.stats = collections.Counter()
        # a name builds a new engine on ``device`` ("cuda" unless given, the
        # mesh's first device with a mesh); an instance is adopted with its
        # own device and shares the app's stats
        self.engine = make_engine(
            engine, impl=impl, device=device, mesh=mesh,
            device_densify=device_densify, stats=self.stats, manager=plan_manager,
        )
        self.device = self.engine.device
        # observability binding only: engine.info() reads the replication
        # surface off this coordinator when its plan manager carries none
        self.engine.coordinator = coordinator
        self._seen: collections.OrderedDict = collections.OrderedDict()
        self._dedup_window = dedup_window
        self._snapshot: Optional[SystemState] = None
        # error management (paper SS3.4): events from the future (app behind)
        # are parked and replayed after a refresh; events from the past are
        # dead-lettered with enough info to reset the Kafka offset
        self._parked: List[CDCEvent] = []
        self.dead_letter: List[CDCEvent] = []
        # rows produced by a replay inside a lazy refresh; delivered by the
        # next consume() / take_replayed() so they are never lost
        self._replay_rows: List[CanonicalRow] = []
        # weak registration: the coordinator must not keep this app alive
        coordinator.on_evict(self._on_coordinator_evict, weak=True)
        self.refresh()

    # -- state management -----------------------------------------------------
    def refresh(self) -> List[CanonicalRow]:
        """Re-snapshot the coordinator state and replay parked events.

        Returns the rows produced by the replay.  Replayed events are
        counted under ``stats["replayed"]`` only (they were counted under
        ``stats["events"]`` when they first arrived)."""
        self._snapshot = self.coordinator.snapshot()
        self.engine.compile(self._snapshot, self.coordinator.registry)
        self.stats["refreshes"] += 1
        rows: List[CanonicalRow] = []
        if self._parked:
            replay, self._parked = self._parked, []
            for ev in replay:  # parked events were dedup-registered
                self._seen.pop(ev.key, None)
            rows = self.engine.consume_groups(self.triage(replay, replay=True))
            self.stats["replayed"] += len(replay)
        return rows

    def reset_offset(self) -> Optional[int]:
        """Smallest dead-lettered stream position -- where to rewind the
        Kafka offset for a re-pull (paper SS3.4).  Clears the dead letter."""
        if not self.dead_letter:
            return None
        pos = min(ev.ts for ev in self.dead_letter)
        for ev in self.dead_letter:  # will be re-delivered; forget dedup keys
            self._seen.pop(ev.key, None)
        self.dead_letter.clear()
        return pos

    def _on_coordinator_evict(self, i: int) -> None:
        self.evict()

    def evict(self) -> None:
        """Cache eviction on state change (the Caffeine analogue)."""
        self.engine.evict()
        self._snapshot = None
        self.stats["evictions"] += 1

    def reset_dedup(self) -> None:
        """Forget every dedup key (for harnesses that re-consume a chunk)."""
        self._seen.clear()

    def ensure_ready(self) -> None:
        """Lazy refresh (after eviction / before first use); replayed rows
        are buffered for the next consume() / take_replayed()."""
        if self._snapshot is None or not self.engine.ready:
            self._replay_rows.extend(self.refresh())

    def take_replayed(self) -> List[CanonicalRow]:
        """Drain rows produced by parked-event replay inside a lazy refresh."""
        rows, self._replay_rows = self._replay_rows, []
        return rows

    @property
    def state(self) -> int:
        """The system state ``i`` the app serves (refreshing lazily)."""
        self.ensure_ready()
        return self._snapshot.i

    @property
    def engine_name(self) -> str:
        return self.engine.name

    # -- triage + mapping --------------------------------------------------------
    def triage(
        self,
        events: Union[Iterable[CDCEvent], ColumnarChunk],
        *,
        replay: bool = False,
    ) -> TriagedChunk:
        """Per-event dedup / state check / parking; returns the mappable
        events bucketed by (schema, version) in columnar form.

        Events flagged ``bad`` (non-numeric payload values) are
        dead-lettered and counted under ``stats["bad_payload"]``.  With
        ``replay=True`` the events are not re-counted under
        ``stats["events"]``."""
        if not replay:
            self.ensure_ready()
        chunk = events if isinstance(events, ColumnarChunk) else columnarize(events)
        by_column: Dict = collections.defaultdict(list)
        # the loop runs on python scalars pulled from the chunk's metadata
        # columns once; CDCEvent objects are touched only on the park /
        # dead-letter paths
        states, schema_ids, versions = chunk.meta_columns()
        keys = chunk.keys.tolist()
        bad = chunk.bad.tolist()
        states = states.tolist()
        schema_ids = schema_ids.tolist()
        versions = versions.tolist()
        app_state = self._snapshot.i
        seen = self._seen
        window = self._dedup_window
        stats = self.stats
        # bulk-count arrivals unless a mid-chunk strict-state raise could
        # leave the count legitimately partial
        if not replay and not self.strict_state:
            stats["events"] += len(keys)
        for e, key in enumerate(keys):
            if not replay and self.strict_state:
                stats["events"] += 1
            if key in seen:
                stats["duplicates"] += 1
                continue
            seen[key] = True
            while len(seen) > window:
                seen.popitem(last=False)
            if bad[e]:
                # un-scatterable payload: dead-letter for offset reset after
                # the producer is fixed
                self.dead_letter.append(chunk.events[e])
                stats["bad_payload"] += 1
                stats["dead_lettered"] += 1
                continue
            if states[e] != app_state:
                stats["stale"] += 1
                if self.strict_state:
                    raise StaleStateError(
                        f"event state {states[e]} != app state {app_state}"
                    )
                if states[e] > app_state:
                    # the *app* is behind: park, replayed after refresh
                    self._parked.append(chunk.events[e])
                    stats["parked"] += 1
                else:
                    # the event is outdated: dead-letter for offset reset
                    self.dead_letter.append(chunk.events[e])
                    stats["dead_lettered"] += 1
                continue
            by_column[(schema_ids[e], versions[e])].append(e)
        tri = TriagedChunk(
            chunk=chunk,
            by_column={
                ov: np.asarray(idx, dtype=np.int64) for ov, idx in by_column.items()
            },
        )
        # residency tiering: every mappable event passes here, so the
        # manager's per-(o, v) hit counters are fed here
        mgr = self.engine.manager
        if mgr.tiering is not None and tri.by_column:
            mgr.record_hits(tri.by_column)
        return tri

    def consume(
        self, events: Union[Iterable[CDCEvent], ColumnarChunk]
    ) -> List[CanonicalRow]:
        """Map a chunk of events (legacy list or columnar) to canonical rows:
        triage per event, then densify -> dispatch -> emit per chunk.
        Rows of a replay tripped by the triage's lazy refresh come first."""
        rows = self.engine.consume_groups(self.triage(events))
        replayed = self.take_replayed()
        return replayed + rows if replayed else rows

    # -- scalar oracle path (pure Algorithm 6; used in tests) -------------------
    def consume_scalar(self, events: Iterable[CDCEvent]) -> List[Message]:
        """Map events one message at a time through the snapshot's DPM
        (:func:`~repro_torch.core.dmm.map_message_dense`); events of another
        state are skipped.  No dedup, parking or stats."""
        self.ensure_ready()
        out: List[Message] = []
        for ev in events:
            msg = ev.message().densify()
            if msg.state != self._snapshot.i:
                continue
            out.extend(map_message_dense(self._snapshot.dpm, self.coordinator.registry, msg))
        return out
