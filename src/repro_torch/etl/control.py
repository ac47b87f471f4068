"""(Port copy of ``repro.etl.control``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Typed control-plane events: schema changes as first-class stream citizens.

The paper's DMM claims *automated updates in response to schema changes* on
a live stream (SS5.4) across horizontally-scaled METL instances that must
all run the same state ``i`` (SS3.4, SS5.5).  This module is that claim as
an API: each schema-registry workflow step is a typed, immutable
:class:`ControlEvent` that can travel **in-band** with the CDC data stream
(:mod:`repro.etl.pipeline` applies them at chunk boundaries) and is applied
declaratively by the single-writer coordinator
(:meth:`repro_torch.core.state.StateCoordinator.apply`), which appends every
applied event to its epoch-ordered ``control_log``.

Event -> paper mapping:

  :class:`SchemaAdded`     a brand-new extraction schema or CDM entity
      registered at version 1 (SS3.3 semi-automated registry workflow; the
      Algorithm-5 ``added_*`` trigger with nothing to copy).
  :class:`SchemaEvolved`   version v -> v+1 of an existing schema: kept
      attributes re-issued with equivalence links, fresh ones added
      (SS5.4.1, Fig. 6 -- the trigger the automated update copies blocks
      across).
  :class:`VersionDeleted`  retirement of one schema version; Algorithm-5
      cases (1)/(2) drop the version's row/column blocks (SS5.4.2).
  :class:`MatrixEdit`      the manual mapping-matrix edit (UI / CSV upload,
      SS3.3): a full DPM replacement that bumps ``i`` without touching the
      trees.
  :class:`Freeze`/:class:`Thaw`  the initial-load windows of SS3.4/SS6.4:
      "during these slots, changes to the schemata and, therefore, to the
      distributed system and the matrix, can be disabled".  Data keeps
      flowing; schema changes arriving inside the window are rejected (or,
      in-band, deferred and re-admitted by the ``Thaw``).
  :class:`PlanPublished`   a :class:`~repro_torch.etl.plan.PlanManager` published
      a freshly (re)built device plan epoch.  An observability record, not
      a mutation: it bumps neither the state ``i`` nor the trees, evicts
      nothing, and is legal inside a Freeze window (plans may rebuild while
      schema changes are disabled -- data keeps flowing on the new table).
      Logged so a replayed log reconstructs the full plan-lifecycle
      timeline alongside the state transitions.

Every schema event knows its Algorithm-5 trigger tuple
(``(kind, schema_id, version)``): :meth:`ControlEvent.mutate` performs the
registry mutation and returns the trigger the coordinator feeds to
:func:`repro_torch.core.dmm.auto_update_dpm`.

**Log replay** (:func:`replay_control_log`) is the durable single-writer
story: a fresh instance reconstructs any state ``i`` by replaying the
coordinator's ``control_log`` over a seed registry -- typed events are pure
data, so the replayed registry, state counter and DPM are bit-identical to
the original's.  Closure-based ``apply_update`` records are opaque and make
a log non-replayable (:class:`ControlReplayError`), which is why that path
is deprecated.

**Replayable-only transport contract.**  The replicated control plane
(:mod:`repro.etl.replication`) ships log records between processes, so only
``replayable`` events may cross a transport boundary: a follower rebuilds
state exclusively by re-applying events, and an opaque closure cannot be
re-applied (or even serialized).  The wire codec
(:mod:`repro.etl.transport`) therefore rejects non-replayable events --
``ClosureUpdate`` included -- with a :class:`ControlReplayError` at encode
time, *before* anything hits the wire, rather than failing with a
serialization crash on the far side.  Deferred (queued-but-unlogged) events
are likewise volatile: they never travel, because exactly-once replication
covers *applied* control only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional, Tuple

from ..core.dmm import DPM
from ..core.registry import Registry, SchemaTree
from ..core.state import ControlRecord, StateCoordinator

__all__ = [
    "ControlEvent",
    "SchemaAdded",
    "SchemaEvolved",
    "VersionDeleted",
    "MatrixEdit",
    "Freeze",
    "Thaw",
    "PlanPublished",
    "ControlReplayError",
    "replay_control_log",
]


class ControlReplayError(RuntimeError):
    """A control log contains a record that cannot be replayed (an opaque
    closure-based update); the reconstructing instance must restore from a
    DUSB snapshot instead."""


@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """Base of the typed control-event union (see module docstring).

    ``op`` is the coordinator dispatch key (``"schema"`` events implement
    :meth:`mutate`; ``"matrix"`` events carry ``dpm``; ``"freeze"`` /
    ``"thaw"`` are pure window markers).  ``replayable`` marks whether a
    log containing the event can reconstruct state from a seed registry.
    """

    op: ClassVar[str] = "schema"
    replayable: ClassVar[bool] = True

    def mutate(self, registry: Registry) -> Tuple[str, int, int]:
        """Perform the registry mutation; return the Algorithm-5 trigger."""
        raise NotImplementedError


def _tree(registry: Registry, name: str) -> SchemaTree:
    if name == "domain":
        return registry.domain
    if name == "range":
        return registry.range
    raise ValueError(f"tree must be 'domain' or 'range', got {name!r}")


def _kind(name: str, added: bool) -> str:
    return ("added_" if added else "deleted_") + name


@dataclasses.dataclass(frozen=True)
class SchemaAdded(ControlEvent):
    """Register a brand-new schema (version 1 by default) in one tree."""

    tree: str  # "domain" (extraction schema) | "range" (CDM entity)
    schema_id: int
    names: Tuple[str, ...]
    version: int = 1

    def mutate(self, registry: Registry) -> Tuple[str, int, int]:
        registry.add_schema(
            _tree(registry, self.tree), self.schema_id, list(self.names),
            version=self.version,
        )
        return (_kind(self.tree, added=True), self.schema_id, self.version)


@dataclasses.dataclass(frozen=True)
class SchemaEvolved(ControlEvent):
    """Cut version v+1 of an existing schema: ``keep`` names are re-issued
    with equivalence links (``a' == a``), ``add`` names are fresh."""

    tree: str
    schema_id: int
    keep: Tuple[str, ...]
    add: Tuple[str, ...] = ()

    def mutate(self, registry: Registry) -> Tuple[str, int, int]:
        tree = _tree(registry, self.tree)
        v = tree.latest_version(self.schema_id)
        registry.evolve(
            tree, self.schema_id, keep=list(self.keep), add=list(self.add)
        )
        return (_kind(self.tree, added=True), self.schema_id, v + 1)


@dataclasses.dataclass(frozen=True)
class VersionDeleted(ControlEvent):
    """Retire one schema version (Algorithm-5 cases 1/2: the version's
    blocks leave the DPM)."""

    tree: str
    schema_id: int
    version: int

    def mutate(self, registry: Registry) -> Tuple[str, int, int]:
        registry.delete_version(
            _tree(registry, self.tree), self.schema_id, self.version
        )
        return (_kind(self.tree, added=False), self.schema_id, self.version)


@dataclasses.dataclass(frozen=True, eq=False)
class MatrixEdit(ControlEvent):
    """Manual matrix edit: replace the authoritative DPM wholesale and bump
    ``i`` (the UI / CSV-upload path; no tree mutation, no Algorithm 5)."""

    op: ClassVar[str] = "matrix"
    dpm: DPM = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # snapshot at construction: the event lives on in the control log,
        # and a caller mutating its dict afterwards would silently break
        # the log's bit-exact replay guarantee
        object.__setattr__(self, "dpm", dict(self.dpm))


@dataclasses.dataclass(frozen=True)
class Freeze(ControlEvent):
    """Open an initial-load window: schema/matrix changes are disabled
    (rejected, or deferred when applied in-band) until the next Thaw."""

    op: ClassVar[str] = "freeze"


@dataclasses.dataclass(frozen=True)
class Thaw(ControlEvent):
    """Close the initial-load window and re-admit deferred schema changes
    in their arrival order."""

    op: ClassVar[str] = "thaw"


@dataclasses.dataclass(frozen=True)
class PlanPublished(ControlEvent):
    """A plan epoch went live: the :class:`~repro_torch.etl.plan.PlanManager`
    (the ONLY component that may construct or publish fused plans -- the
    ``plan-publish-single-site`` analyzer rule enforces it) finished a
    build and is serving it.

    Pure observability: no state bump, no eviction, legal during a Freeze.
    In-flight chunks pinned to the previous epoch keep draining on the old
    table (the ``DenseChunk.plan`` pin); the record marks where in the
    control timeline the cutover happened.

    ``epoch`` is the manager's monotone build counter (NOT the registry
    state ``i`` -- several epochs can serve one state when the residency
    policy repartitions); ``state`` is the state the plan was built for;
    ``incremental`` tells a splice (:func:`repro_torch.core.dmm_torch.splice_fused`)
    from a full rebuild, with ``touched_columns`` columns re-lowered;
    ``bytes_resident`` / ``n_blocks`` describe the published table and
    ``rebuild_s`` what the build cost.
    """

    op: ClassVar[str] = "plan"
    epoch: int = 0
    state: int = 0
    kind: str = "fused"
    incremental: bool = False
    touched_columns: int = 0
    n_blocks: int = 0
    bytes_resident: int = 0
    rebuild_s: float = 0.0


def replay_control_log(
    log: "list[ControlRecord]",
    registry: Optional[Registry] = None,
    dpm: Optional[DPM] = None,
    *,
    coordinator: Optional[StateCoordinator] = None,
) -> StateCoordinator:
    """Reconstruct a coordinator by replaying a control log over a seed.

    ``registry``/``dpm`` must be the seed the original coordinator started
    from (e.g. a deterministic scenario rebuild, or a DUSB restore).  Every
    record is re-applied in epoch order and its resulting state checked
    against the recorded one; the returned coordinator's registry, state
    counter and DPM are bit-identical to the original single writer's --
    which is how a fresh METL instance joins a running deployment at the
    current state ``i``.

    Passing ``coordinator=`` replays *onto an existing coordinator* instead
    of building a fresh one -- the follower catch-up path
    (:mod:`repro.etl.replication`): the replica advances incrementally as
    log suffixes arrive, and its registered evict hooks fire exactly as the
    leader's did.  Each record's ``seq`` must then equal the coordinator's
    current ``log_offset`` (contiguity check: no gaps, no rewinds) -- a
    coordinator restored from a (seed snapshot, log offset) pair starts
    accepting records at exactly that offset.

    This is the ONLY sanctioned write path for follower replicas; direct
    ``StateCoordinator.apply`` calls outside the leader are flagged by the
    ``single-writer-control`` analyzer rule.

    Raises :class:`ControlReplayError` on opaque (closure-based) records,
    on a state mismatch (wrong seed), or on a seq gap.
    """
    if coordinator is None:
        if registry is None:
            raise TypeError("replay_control_log needs a registry or coordinator=")
        coord = StateCoordinator(registry, dpm)
    else:
        coord = coordinator
    for rec in log:
        if rec.seq != coord.log_offset:
            raise ControlReplayError(
                f"log gap: record seq {rec.seq} != expected {coord.log_offset}"
            )
        event = rec.event
        if not getattr(event, "replayable", True):
            raise ControlReplayError(
                f"log record {rec.seq} is not replayable: {event!r}"
            )
        snap = coord.apply(event)
        if snap.i != rec.state:
            raise ControlReplayError(
                f"replay diverged at record {rec.seq}: state {snap.i} != "
                f"recorded {rec.state} (wrong seed registry?)"
            )
    return coord
