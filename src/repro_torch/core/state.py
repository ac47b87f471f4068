"""(Port copy of ``repro.core.state``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Distributed system-state protocol (paper SS3.4-3.5, SS5.5).

The mapping system is distributed: registry, matrix, messages and N
horizontally-scaled METL instances each carry a state ``i``.  The paper's
rules, which we enforce here:

  * all scaled app instances must run the same state ``i`` or they "may be
    producing different messages as a result";
  * a state change (schema version add/delete, manual matrix edit) bumps
    ``i`` and **evicts** every derived cache (the paper evicts Caffeine);
  * during initial-load windows state changes are disabled.

**Control plane.**  State transitions are driven declaratively through
:meth:`StateCoordinator.apply` with a typed control event
(:mod:`repro_torch.etl.control`: ``SchemaAdded`` / ``SchemaEvolved`` /
``VersionDeleted`` / ``MatrixEdit`` / ``Freeze`` / ``Thaw``).  Every applied
event is appended to the epoch-ordered, replayable ``control_log`` -- the
coordinator is the pipeline's *single state writer*, and the log is the
durable record of its writes: a fresh instance reconstructs any state ``i``
by replaying the log over a seed registry
(:func:`repro_torch.etl.control.replay_control_log`).  The closure-based
:meth:`apply_update` and :meth:`set_dpm` survive as thin deprecated shims;
closure updates are logged as opaque (non-replayable) records.

In the SPMD training framework the "instances" are the per-host data-loading
processes of the mesh's ``data``/``pod`` axes: every host derives its shard
of the canonical batch from (state i, step), so any host can recompute any
other host's shard -- that determinism is the straggler/elasticity story.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .dmm import DPM, transform_to_dusb, decompact_dusb, transform_to_dpm, DUSB
from .registry import Registry, StaleStateError

__all__ = ["SystemState", "StateCoordinator", "ControlRecord", "ClosureUpdate"]


@dataclasses.dataclass
class SystemState:
    """An immutable snapshot: (state i, DPM) -- what one METL instance runs."""

    i: int
    dpm: DPM

    def check(self, other_i: int) -> None:
        if other_i != self.i:
            raise StaleStateError(f"instance state {self.i} != message state {other_i}")


@dataclasses.dataclass(frozen=True)
class ControlRecord:
    """One applied control event, in application (epoch) order.

    ``seq`` is the log position, ``state`` the registry state *after* the
    event applied (``Freeze``/``Thaw`` leave it unchanged).  Replaying the
    records of ``coordinator.control_log`` in order over a seed registry
    reproduces every intermediate state bit-exactly
    (:func:`repro_torch.etl.control.replay_control_log`).
    """

    seq: int
    state: int
    event: Any


class ClosureUpdate:
    """Opaque log marker for the deprecated closure-based
    :meth:`StateCoordinator.apply_update` path.

    Carries the Algorithm-5 trigger tuple for observability, but the
    registry mutation itself was an arbitrary closure, so the record is NOT
    replayable -- which is exactly why the closure API is deprecated in
    favour of the typed events in :mod:`repro_torch.etl.control`.
    """

    op = "schema"
    replayable = False

    def __init__(self, mutate: Callable[[Registry], Tuple[str, int, int]]) -> None:
        self._mutate = mutate
        self.trigger: Optional[Tuple[str, int, int]] = None

    def mutate(self, registry: Registry) -> Tuple[str, int, int]:
        if self.trigger is not None:
            raise RuntimeError(
                "closure-based updates cannot be replayed; use the typed "
                "control events (repro_torch.etl.control) for replayable logs"
            )
        self.trigger = self._mutate(registry)
        return self.trigger

    def __repr__(self) -> str:  # log readability
        return f"ClosureUpdate(trigger={self.trigger})"


class StateCoordinator:
    """Single-writer coordinator for state transitions.

    Owns the registry and the authoritative DPM; hands out immutable
    :class:`SystemState` snapshots to instances.  All transitions flow
    through :meth:`apply` (see the module docstring); ``Freeze`` implements
    the paper's initial-load windows: "during these slots, changes to the
    schemata and, therefore, to the distributed system and the matrix, can
    be disabled".
    """

    def __init__(
        self,
        registry: Registry,
        dpm: Optional[DPM] = None,
        *,
        frozen: bool = False,
        log_base: int = 0,
    ) -> None:
        self._lock = threading.Lock()
        self.registry = registry
        self._dpm: DPM = dict(dpm or {})
        self._frozen = frozen
        self._evict_hooks: List[Any] = []
        # the epoch-ordered single-writer log: every applied control event,
        # in application order, with the state it produced.  ``log_base`` is
        # the global seq of the first in-memory record: a follower restored
        # from a (seed snapshot, log offset) pair keeps only the suffix of
        # the leader's log, so record seqs are ``log_base + local index``.
        # Deferred events are deliberately NOT restorable: they are volatile
        # until logged at Thaw (exactly-once covers *applied* control only).
        self.log_base = log_base
        self.control_log: List[ControlRecord] = []
        # schema changes deferred by apply(..., defer_frozen=True) during an
        # initial-load window; re-admitted in arrival order by Thaw
        self._deferred: List[Any] = []
        # replication role, set by repro.etl.replication when this
        # coordinator joins a leader/follower cluster; None = standalone
        # (which reports as a single-process "leader")
        self.replication: Optional[Any] = None

    # -- snapshots -----------------------------------------------------------
    def snapshot(self) -> SystemState:
        with self._lock:
            return SystemState(i=self.registry.state, dpm=dict(self._dpm))

    # -- replication surface --------------------------------------------------
    @property
    def log_offset(self) -> int:
        """Global seq the next applied record will receive."""
        return self.log_base + len(self.control_log)

    @property
    def is_control_writer(self) -> bool:
        """True unless a replication role marks this coordinator a follower.

        Leaders and standalone coordinators may :meth:`apply`; follower
        replicas must only advance through
        :func:`repro_torch.etl.control.replay_control_log` (the
        ``single-writer-control`` analyzer rule enforces this statically).
        """
        role = getattr(self.replication, "role", "leader")
        return role != "follower"

    def replication_info(self) -> Dict[str, Any]:
        """The documented replication observability keys.

        ``role``         ``"leader"`` / ``"follower"`` (standalone
                         coordinators report ``"leader"``)
        ``term``         the fencing term of the writer this coordinator
                         follows (0 when standalone)
        ``log_offset``   global control-log position (base + applied records)
        ``lag_records``  records the leader has shipped that this replica has
                         not yet applied (0 for leaders/standalone)
        """
        rep = self.replication
        return {
            "role": getattr(rep, "role", "leader"),
            "term": int(getattr(rep, "term", 0)),
            "log_offset": self.log_offset,
            "lag_records": int(getattr(rep, "lag_records", 0)),
        }

    # -- cache-eviction fan-out (the Caffeine analogue) ----------------------
    def on_evict(self, hook: Callable[[int], None], *, weak: bool = False) -> None:
        """Register an eviction hook ``hook(new_state)``.

        With ``weak=True`` the hook must be a *bound method* and the
        coordinator holds only a weak reference to its owner: when the owner
        is garbage-collected the hook is pruned at the next eviction instead
        of keeping dead instances alive forever (METL apps register this
        way -- constructing many apps against one coordinator must not grow
        the hook list without bound).
        """
        self._evict_hooks.append(weakref.WeakMethod(hook) if weak else hook)

    @property
    def n_evict_hooks(self) -> int:
        """Live hook count (dead weak hooks are pruned on eviction)."""
        return len(self._evict_hooks)

    def _evict_all(self) -> None:
        i = self.registry.state
        live: List[Any] = []
        for hook in self._evict_hooks:
            if isinstance(hook, weakref.WeakMethod):
                fn = hook()
                if fn is None:  # owner collected: prune silently
                    continue
                fn(i)
            else:
                hook(i)
            live.append(hook)
        self._evict_hooks = live

    # -- load windows ---------------------------------------------------------
    @property
    def frozen(self) -> bool:
        return self._frozen

    @property
    def deferred_control(self) -> Tuple[Any, ...]:
        """Schema changes queued during the current initial-load window."""
        return tuple(self._deferred)

    def freeze(self) -> None:
        from ..etl.control import Freeze  # core must not import etl at load

        self.apply(Freeze())

    def thaw(self) -> None:
        from ..etl.control import Thaw  # core must not import etl at load

        self.apply(Thaw())

    def _require_mutable(self) -> None:
        if self._frozen:
            raise RuntimeError(
                "state changes are disabled during an initial-load window"
            )

    # -- transitions -----------------------------------------------------------
    def apply(self, event: Any, *, defer_frozen: bool = False) -> SystemState:
        """Apply one typed control event; the single-writer transition.

        ``event`` is any object implementing the control protocol
        (:mod:`repro_torch.etl.control`): an ``op`` of ``"freeze"`` / ``"thaw"`` /
        ``"plan"`` / ``"matrix"`` / ``"schema"``, plus ``mutate(registry) ->
        trigger`` for schema changes and ``dpm`` for matrix edits.  Schema
        changes run the registry mutation and the Algorithm-5 automated DPM
        update atomically, then evict every derived cache; the applied event
        is appended to :attr:`control_log`.  ``"plan"`` events
        (``PlanPublished``) are pure observability records: logged in epoch
        order but bumping nothing, evicting nothing, and -- unlike
        schema/matrix changes -- legal inside a Freeze window.

        During an initial-load window (``Freeze``) schema/matrix changes
        raise -- or, with ``defer_frozen=True`` (the streaming pipeline's
        in-band mode), are queued and re-admitted in arrival order when the
        ``Thaw`` lands.  Returns the resulting :class:`SystemState`.
        """
        from .dmm import auto_update_dpm

        op = getattr(event, "op", None)
        if op not in ("freeze", "thaw", "plan", "matrix", "schema"):
            raise TypeError(
                f"not a control event: {event!r} (see repro_torch.etl.control)"
            )
        evict = False
        report = None
        with self._lock:
            if op == "freeze":
                self._frozen = True
            elif op == "thaw":
                self._frozen = False
            elif op == "plan":
                pass  # observability record: no bump, no evict; the branch
                # sits BEFORE the frozen gate because plan rebuilds stay
                # legal inside a load window (data keeps flowing)
            elif self._frozen:
                if defer_frozen:
                    # queued, NOT logged: the log records applied events only
                    self._deferred.append(event)
                    return SystemState(i=self.registry.state, dpm=dict(self._dpm))
                raise RuntimeError(
                    "state changes are disabled during an initial-load window"
                )
            elif op == "matrix":
                self._dpm = dict(event.dpm)
                self.registry.bump_state()
                evict = True
            else:  # op == "schema"
                change = event.mutate(self.registry)
                self._dpm, report = auto_update_dpm(self._dpm, self.registry, change)
                evict = True
            self.control_log.append(
                ControlRecord(
                    seq=self.log_base + len(self.control_log),
                    state=self.registry.state,
                    event=event,
                )
            )
            snap = SystemState(i=self.registry.state, dpm=dict(self._dpm))
        if report is not None:
            self.last_report = report
        if evict:
            self._evict_all()
        if op == "thaw" and self._deferred:
            deferred, self._deferred = self._deferred, []
            for ev in deferred:  # re-admitted in arrival order
                snap = self.apply(ev)
        return snap

    def apply_update(
        self, mutate: Callable[[Registry], Tuple[str, int, int]]
    ) -> SystemState:
        """Deprecated closure shim: run a registry mutation + automated DPM
        update atomically.

        ``mutate`` performs the registry change and returns the Algorithm-5
        trigger tuple.  Prefer :meth:`apply` with a typed event from
        :mod:`repro_torch.etl.control` -- the closure is logged as an opaque,
        non-replayable :class:`ClosureUpdate` record.
        """
        return self.apply(ClosureUpdate(mutate))

    def set_dpm(self, dpm: DPM) -> None:
        """Deprecated shim for a manual matrix edit (UI / CSV upload path);
        prefer ``apply(MatrixEdit(dpm=...))``."""
        from ..etl.control import MatrixEdit  # core must not import etl at load

        self.apply(MatrixEdit(dpm=dpm))

    # -- hybrid persistence (paper SS6.2) --------------------------------------
    def to_dusb(self) -> DUSB:
        """Compact the live DPM through iM to iDUSB for storage."""
        from .dmm import decompact_dpm

        with self._lock:
            matrix = decompact_dpm(self._dpm, self.registry)
            return transform_to_dusb(matrix)

    @classmethod
    def from_dusb(cls, registry: Registry, dusb: DUSB) -> "StateCoordinator":
        """Restart path: DUSB --Alg.4--> iM --Alg.2--> DPM ("a clear path to
        recreate iDPM from iDUSB with two algorithms")."""
        matrix = decompact_dusb(dusb, registry)
        return cls(registry, transform_to_dpm(matrix))
