"""(Port copy of ``repro.etl.cluster``, on PyTorch: every instance's
``METLApp`` runs on ``device``, the card unless the caller passes
``device="cpu"``; each builds its own engine, host arenas and plan there.)

Multi-instance METL runtime: N pipelines, one state writer (paper SS5.5).

The paper scales METL horizontally: several identical app instances consume
disjoint slices of the CDC stream, and correctness hinges on every instance
running the same state ``i`` ("otherwise they may be producing different
messages as a result", SS3.4).  DOD-ETL (Machado et al 2019) uses the same
shape -- identical pipeline instances fanned off one coordinated stream.
:class:`Cluster` is that deployment as a library object, built entirely on
the public seams of the Pipeline/engine redesign:

  * **deterministic slicing** -- instance ``k`` of ``N`` owns global chunk
    indices ``k, k+N, 2N+k, ...`` of one chunk grid
    (:class:`~repro_torch.etl.pipeline.EventChunkSource` with ``stride=N,
    offset=k``).  Slices are pure in (state, position), so any instance --
    or a replacement spun up later -- can recompute any other's share;
  * **single writer** -- all instances share one
    :class:`~repro_torch.core.state.StateCoordinator`.  In-band control events
    are routed through :meth:`Cluster.apply_control`, which applies each
    event to the coordinator exactly once (the owning instance's source
    delivers it; the eviction fan-out broadcasts the epoch change to every
    instance, whose next chunk lazily recompiles at the new state);
  * **lockstep rounds** -- :meth:`run` drives the instances in global
    chunk-grid order (round ``g`` advances instance ``g mod N`` by one
    chunk), so a mid-stream evolution lands at the same stream position on
    every instance and the merged output is bit-identical, row for row, to
    a single instance consuming the unsliced stream;
  * **merge fan-in** -- all instance pipelines write the same sink list
    (the single-writer ingest of the DW / serve batcher).  Because rounds
    are lockstep on one thread, the merged row order is deterministic;
  * **cross-instance dead-letter replay** -- :meth:`replay_dead_letters`
    drains each instance's dead letter via ``METLApp.reset_offset()``, routes
    the rewind position to the *owning* instance's source through the
    ``Source.reset_offset`` contract (ownership is a pure function of the
    chunk grid), and re-runs exactly the re-delivered chunks.

``Cluster.info()`` aggregates the per-instance ``engine.info()`` surfaces.
Documented keys: ``instances`` (count), ``engine`` (name), ``state``
(coordinator state ``i``), ``states`` (distinct per-instance plan states --
a singleton when all instances agree), ``control_log`` (applied control
events), ``dispatches`` / ``events`` / ``mapped`` / ``dead_letter``
(summed over instances), ``plan_epoch`` (max per-instance plan-manager
epoch), ``rebuilds`` (plan builds summed over instances),
``bytes_resident`` (device-resident plan bytes summed over instances --
the cluster's total table footprint under the residency policy),
``role`` / ``term`` / ``log_offset`` / ``lag_records`` (replication
surface from :meth:`StateCoordinator.replication_info`: the control-plane
role -- ``"leader"`` for any unreplicated or leader-bound coordinator,
``"follower"`` for a replica -- the fencing term, the next control-log
sequence number, and how many received-but-unapplied records the replica
is behind by; an unreplicated cluster reports
``role="leader", term=0, lag_records=0``), ``per_instance`` (the raw
``engine.info()`` dicts, instance order).  This is the supported
observability surface for launchers (``serve --etl --instances N``) and
benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.dmm_torch import DeviceLike
from ..core.state import StateCoordinator
from .control import ControlEvent
from .engines import MappingEngine
from .events import EventSource
from .metl import METLApp
from .pipeline import ControlSchedule, EventChunkSource, Pipeline, RowSink, Source

__all__ = ["Cluster", "ClusterStats"]


@dataclasses.dataclass
class ClusterStats:
    """Per-``run()`` accounting summed over instances (per-instance detail
    lives in each ``app.stats`` / ``engine.info()``)."""

    rounds: int = 0
    chunks: int = 0
    events: int = 0
    rows: int = 0
    control: int = 0

    def merge(self, st) -> None:
        self.chunks += st.chunks
        self.events += st.events
        self.rows += st.rows
        self.control += st.control


class Cluster:
    """N :class:`~repro_torch.etl.pipeline.Pipeline` instances over deterministic
    stream slices, one coordinator as the single state writer (see module
    docstring)."""

    def __init__(
        self,
        coordinator: StateCoordinator,
        sources: Sequence[Source],
        sinks: Sequence[RowSink],
        *,
        engine: Any = "fused",
        mesh: Any = None,
        impl: str = "gather",
        device: DeviceLike = "cuda",
        device_densify: bool = False,
        async_consume: bool = False,
        strict_state: bool = False,
        grid: Optional[tuple] = None,
    ) -> None:
        if not sources:
            raise ValueError("a cluster needs at least one source")
        if isinstance(engine, MappingEngine) and len(sources) > 1:
            raise ValueError(
                "engine instances cannot be shared across cluster instances; "
                "pass a registered engine name so each app builds its own"
            )
        self.coordinator = coordinator
        self.sources = list(sources)
        self.sinks = list(sinks)
        self.apps = [
            METLApp(coordinator, engine=engine, mesh=mesh, impl=impl, device=device,
                    device_densify=device_densify, strict_state=strict_state)
            for _ in self.sources
        ]
        # every instance pipeline shares the sink list (the merge fan-in)
        # and routes in-band control through the cluster's single writer
        self.pipelines = [
            Pipeline(src, app, self.sinks, async_consume=async_consume,
                     apply_control=self.apply_control)
            for src, app in zip(self.sources, self.apps)
        ]
        self._applied: set = set()
        self._round = 0  # persistent lockstep cursor (global chunk index)
        self._grid = grid  # (start, chunk_size, instances) when over_stream

    # -- construction ----------------------------------------------------------
    @classmethod
    def over_stream(
        cls,
        coordinator: StateCoordinator,
        stream: EventSource,
        *,
        instances: int = 4,
        start: int = 0,
        chunk_size: int = 256,
        max_chunks: Optional[int] = None,
        control: Optional[ControlSchedule] = None,
        columnar: bool = True,
        sinks: Sequence[RowSink] = (),
        **kwargs,
    ) -> "Cluster":
        """The standard deployment: slice one deterministic CDC stream over
        ``instances`` strided :class:`EventChunkSource` cursors.

        ``max_chunks`` bounds the *global* chunk count (split round-robin
        over the instances); ``control`` is one shared schedule on the
        global chunk grid -- each scheduled event is delivered by the
        instance owning its chunk index and applied once by the cluster's
        single writer.
        """
        if instances < 1:
            raise ValueError("instances must be >= 1")
        sources = []
        for k in range(instances):
            per = (
                None if max_chunks is None
                else max(0, (max_chunks - k + instances - 1) // instances)
            )
            sources.append(
                EventChunkSource(
                    stream,
                    start=start,
                    chunk_size=chunk_size,
                    max_chunks=per,
                    columnar=columnar,
                    control=control,
                    stride=instances,
                    offset=k,
                )
            )
        return cls(
            coordinator, sources, list(sinks),
            grid=(start, chunk_size, instances), **kwargs,
        )

    # -- the single writer -----------------------------------------------------
    def apply_control(self, event: ControlEvent) -> None:
        """Apply one in-band control event through the cluster's single
        writer, exactly once -- instances that re-deliver the same scheduled
        event object (e.g. a shared schedule) are deduplicated, and the
        coordinator's eviction fan-out broadcasts the epoch change to every
        instance.  Schema changes landing inside a Freeze window are
        deferred and re-admitted by the Thaw (paper SS3.4)."""
        if id(event) in self._applied:
            return
        self._applied.add(id(event))
        self.coordinator.apply(event, defer_frozen=True)

    # -- lockstep execution ----------------------------------------------------
    def _full(self) -> bool:
        return any(s.full() for s in self.sinks)

    def run(self, *, max_rounds: Optional[int] = None) -> ClusterStats:
        """Drive the instances in global chunk-grid order until every source
        is exhausted, a shared sink reports full, or ``max_rounds`` rounds
        ran.  One round advances one instance by one chunk (its pipeline
        applies any control events scheduled before that chunk first), so
        the merged output order is the single-instance order.  Safe to call
        repeatedly: the lockstep cursor and every source cursor persist."""
        st = ClusterStats()
        n = len(self.pipelines)
        idle = 0
        while idle < n:
            if max_rounds is not None and st.rounds >= max_rounds:
                break
            if self._full():
                break
            r = self.pipelines[self._round % n].run(max_chunks=1)
            self._round += 1
            st.rounds += 1
            st.merge(r)
            idle = 0 if r.chunks else idle + 1
        return st

    # -- dead-letter replay ----------------------------------------------------
    def replay_dead_letters(self) -> ClusterStats:
        """Cross-instance dead-letter replay through the ``reset_offset()``
        contract: each instance's dead letter names a stream position; the
        chunk grid names the owning instance; that instance's source rewinds
        and re-delivers the affected chunks *at the current state* (the
        paper's "set back Kafka-offsets and start new initial loads"), and
        its pipeline re-runs exactly those chunks into the shared sinks.
        Typically drained after :meth:`run` completes (replayed rows append
        after the live stream's); drain any bounded sinks first -- a sink
        going full stops the replay early, and the already-rewound chunks
        are then re-delivered by subsequent :meth:`run` rounds instead
        (interleaved with live chunks, losing the global replay order but
        never the rows)."""
        if self._grid is None:
            raise RuntimeError(
                "dead-letter replay needs the chunk grid; build the cluster "
                "with Cluster.over_stream()"
            )
        start, size, n = self._grid
        st = ClusterStats()
        frontiers: Dict[int, int] = {}  # owner -> pre-replay cursor
        for app in self.apps:
            pos = app.reset_offset()
            if pos is None:
                continue
            j = max(0, pos - start) // size  # global chunk containing pos
            owner = j % n
            src = self.sources[owner]
            frontiers.setdefault(owner, src.next_index)
            src.reset_offset(pos)
        # re-pull in global chunk-grid order across the affected owners, so
        # the replayed rows land in the shared sinks in the same order a
        # single instance would re-deliver them
        budgets = {
            owner: max(0, (frontiers[owner] - self.sources[owner].next_index) // n)
            for owner in frontiers
        }
        budgets = {o: b for o, b in budgets.items() if b}
        while budgets:
            if self._full():
                # backpressured: stop here, the rewound cursors re-deliver
                # through ordinary run() rounds once the sink drains
                break
            owner = min(budgets, key=lambda o: self.sources[o].next_index)
            r = self.pipelines[owner].run(max_chunks=1)
            st.rounds += 1
            st.merge(r)
            budgets[owner] -= 1
            if budgets[owner] <= 0 or r.chunks == 0:
                del budgets[owner]
        return st

    # -- observability ---------------------------------------------------------
    def info(self) -> Dict[str, Any]:
        """Aggregated observability over the per-instance ``engine.info()``
        surfaces; see the module docstring for the documented key list."""
        per = [app.engine.info() for app in self.apps]
        return {
            "instances": len(per),
            "engine": per[0].get("engine"),
            "state": self.coordinator.registry.state,
            "states": sorted({i["state"] for i in per if "state" in i}),
            "control_log": len(self.coordinator.control_log),
            "dispatches": sum(i.get("dispatches", 0) for i in per),
            "events": sum(int(app.stats["events"]) for app in self.apps),
            "mapped": sum(int(app.stats["mapped"]) for app in self.apps),
            "dead_letter": sum(len(app.dead_letter) for app in self.apps),
            "plan_epoch": max(i.get("plan_epoch", 0) for i in per),
            "rebuilds": sum(i.get("rebuilds", 0) for i in per),
            "bytes_resident": sum(i.get("bytes_resident", 0) for i in per),
            # replication surface (role/term/log_offset/lag_records); an
            # unreplicated coordinator reports role="leader", term=0
            **self.coordinator.replication_info(),
            "per_instance": per,
        }

    def close(self) -> None:
        """Close every instance pipeline; shared sinks are closed once."""
        for pipe in self.pipelines:
            pipe.close_worker()
        for sink in self.sinks:
            sink.close()
