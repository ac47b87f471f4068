"""(Port copy of ``repro.etl.events``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Synthetic CDC event sources (the Debezium stand-in).

Events are *deterministic* functions of (registry state i, stream position):
any host can regenerate any other host's slice of the stream, which is the
basis of straggler mitigation and elastic re-assignment in the trainer
(DESIGN SS4).  The generator reproduces the paper's operational quirks:

  * at-least-once delivery -- "it is possible that FX emits the same
    data-load twice via different events", controlled by ``p_duplicate``;
  * stale messages -- an event can carry an older state ``i`` than the
    registry (the out-of-sync case of SS3.4), controlled by ``p_stale``;
  * CDC op types (create / update / delete) with before/after payloads;
  * "null" attributes (optional columns), controlled by ``p_null``.

**Columnar chunks.**  The per-event payload dict is the wrong shape for the
hot path: every consume used to re-walk each dict per (uid, value) item in
python.  :class:`ColumnarChunk` flattens a whole chunk ONCE, at the source
boundary, into CSR-style columnar arrays

    uids          int32  (n_items,)   attribute uid per present payload item
    vals          float32(n_items,)   the item's value
    event_offsets int64  (n_events+1,) event e owns items [off[e], off[e+1])

plus the per-event metadata triage needs (the :class:`CDCEvent` objects for
parking / dead-lettering, and a ``keys`` array for routing).  Densification
(:mod:`repro_torch.etl.engines`) then becomes pure numpy -- a vectorised
uid -> slot lookup and one scatter -- with no per-item python.
:func:`columnarize` is the compatibility path that lifts legacy dict-payload
event lists into the same representation, so ``METLApp.consume(list)`` keeps
working; :meth:`EventSource.slice_columnar` builds chunks columnar from the
start.  Non-numeric payload values (str / bool / Decimal / ...) cannot enter
the float32 value column: :func:`columnarize` flags the carrying event in
``bad`` and triage routes it to the dead-letter path with a counted stat
instead of crashing (or silently truncating) inside the scatter.

**In-band control.**  Data events are one half of the stream; the other is
the typed control plane (:mod:`repro_torch.etl.control`): schema-change events
travel through the same stream and are applied at chunk boundaries.  Slices
stay pure in (registry state, position) ACROSS control events -- a chunk
sliced after an evolution is generated at the new state, which is what
makes replayed/re-sliced chunks deterministic on every instance of a
:class:`~repro.etl.cluster.Cluster`.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.registry import Registry
from ..core.dmm import Message

__all__ = ["CDCEvent", "ColumnarChunk", "columnarize", "EventSource"]


@dataclasses.dataclass
class CDCEvent:
    """A log-based CDC event as emitted by the Debezium stand-in."""

    key: int  # unique payload key (dedup handle; survives duplication)
    op: str  # c | u | d
    state: int
    schema_id: int
    version: int
    before: Optional[Dict[int, Optional[float]]]
    after: Optional[Dict[int, Optional[float]]]
    ts: int

    def payload(self) -> Dict[int, Optional[float]]:
        """The mappable payload (the 'after' image; deletes map 'before')."""
        return self.after if self.after is not None else (self.before or {})

    def message(self) -> Message:
        return Message(
            state=self.state,
            schema_id=self.schema_id,
            version=self.version,
            payload=dict(self.payload()),
        )


def _is_numeric(val) -> bool:
    """True for values that can enter the float32 value column bit-exactly
    with the legacy dict walk: real numbers, excluding bool (a bool payload
    is a schema error, not a 0.0/1.0 measurement -- see module docstring)."""
    return isinstance(val, numbers.Real) and not isinstance(val, bool)


@dataclasses.dataclass
class ColumnarChunk:
    """One event chunk flattened into columnar (uid, value) arrays.

    Built once at the source boundary (:meth:`EventSource.slice_columnar`)
    or lifted from a legacy event list (:func:`columnarize`); consumed by
    the engines' pure-numpy densification.  ``events`` keeps the per-event
    metadata triage needs (state / schema / version checks, and the objects
    themselves for parking and dead-lettering); ``None`` payload values are
    dropped at build time (they never scatter), and events carrying a
    non-numeric value contribute NO items and are flagged in ``bad`` for
    triage to dead-letter.
    """

    events: List[CDCEvent]  # per-event metadata, arrival order
    uids: np.ndarray  # int32 (n_items,): attribute uid per present item
    vals: np.ndarray  # float32 (n_items,): the item's value
    event_offsets: np.ndarray  # int64 (n_events+1,): CSR offsets into uids/vals
    keys: np.ndarray  # int64 (n_events,): dedup/emission key per event
    bad: np.ndarray  # bool (n_events,): event carried a non-numeric value
    # triage metadata columns (state / schema / version per event): filled
    # by columnarize (which is walking the events anyway); lazily rebuilt
    # for chunks constructed directly, so triage never touches the CDCEvent
    # objects on the hot path (only the park / dead-letter error paths do)
    states: Optional[np.ndarray] = None  # int64 (n_events,)
    schema_ids: Optional[np.ndarray] = None  # int64 (n_events,)
    versions: Optional[np.ndarray] = None  # int64 (n_events,)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        # iterate the per-event metadata: a ColumnarChunk drops into any
        # code that walked a legacy event-list chunk
        return iter(self.events)

    @property
    def n_items(self) -> int:
        return int(self.uids.size)

    def meta_columns(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The (states, schema_ids, versions) triage columns, built on first
        use when the chunk was constructed without them."""
        if self.states is None:
            n = len(self.events)
            self.states = np.fromiter((ev.state for ev in self.events), np.int64, count=n)
            self.schema_ids = np.fromiter((ev.schema_id for ev in self.events), np.int64, count=n)
            self.versions = np.fromiter((ev.version for ev in self.events), np.int64, count=n)
        return self.states, self.schema_ids, self.versions


def columnarize(events: List[CDCEvent]) -> ColumnarChunk:
    """Flatten a legacy dict-payload event list into a :class:`ColumnarChunk`.

    One python pass per payload item -- the SAME walk the legacy densify did
    per consume, now done exactly once per chunk.  Present numeric items land
    in the (uid, value) columns in dict iteration order; events with any
    non-numeric value are flagged ``bad`` and contribute no items.
    """
    events = list(events)
    uids: List[int] = []
    vals: List[float] = []
    offsets = np.zeros(len(events) + 1, dtype=np.int64)
    keys = np.zeros(len(events), dtype=np.int64)
    bad = np.zeros(len(events), dtype=bool)
    states = np.zeros(len(events), dtype=np.int64)
    schema_ids = np.zeros(len(events), dtype=np.int64)
    versions = np.zeros(len(events), dtype=np.int64)
    for e, ev in enumerate(events):
        keys[e] = ev.key
        states[e] = ev.state
        schema_ids[e] = ev.schema_id
        versions[e] = ev.version
        ev_uids: List[int] = []
        ev_vals: List[float] = []
        for uid, val in ev.payload().items():
            if val is None:
                continue
            if not _is_numeric(val):
                bad[e] = True
                break
            ev_uids.append(uid)
            ev_vals.append(val)
        if not bad[e]:
            uids.extend(ev_uids)
            vals.extend(ev_vals)
        offsets[e + 1] = len(uids)
    # uids live in an int32 column (they index int32 dense tables); a uid
    # beyond that range -- an event racing far ahead of any schema the plan
    # could know -- is unknown by definition, so clamp it to the -1 foreign
    # sentinel instead of overflowing the cast
    u = np.asarray(uids, dtype=np.int64)
    return ColumnarChunk(
        events=events,
        uids=np.where((u >= 0) & (u < np.int64(2**31)), u, -1).astype(np.int32),
        vals=np.asarray(vals, dtype=np.float32),
        event_offsets=offsets,
        keys=keys,
        bad=bad,
        states=states,
        schema_ids=schema_ids,
        versions=versions,
    )


class EventSource:
    """Deterministic synthetic CDC stream over a registry's extraction tree."""

    def __init__(
        self,
        registry: Registry,
        *,
        seed: int = 0,
        p_null: float = 0.25,
        p_duplicate: float = 0.05,
        p_stale: float = 0.0,
        p_update: float = 0.3,
        p_delete: float = 0.05,
    ) -> None:
        self.registry = registry
        self.seed = seed
        self.p_null = p_null
        self.p_duplicate = p_duplicate
        self.p_stale = p_stale
        self.p_update = p_update
        self.p_delete = p_delete

    def _payload(
        self, rng: np.random.Generator, schema_id: int, version: int
    ) -> Dict[int, Optional[float]]:
        sv = self.registry.domain.get(schema_id, version)
        return {
            a.uid: (None if rng.random() < self.p_null else float(rng.integers(1, 1_000_000)))
            for a in sv.attributes
        }

    def slice(self, start: int, count: int) -> List[CDCEvent]:
        """Events [start, start+count) of the stream.  Pure in (state, start,
        count): re-calling with the same arguments returns identical events.
        """
        out: List[CDCEvent] = []
        blocks = self.registry.domain.blocks()
        state = self.registry.state
        pos = start
        while len(out) < count:
            rng = np.random.default_rng((self.seed, state, pos))
            sv = blocks[int(rng.integers(len(blocks)))]
            u = rng.random()
            op = "c" if u >= self.p_update + self.p_delete else ("u" if u >= self.p_delete else "d")
            after = self._payload(rng, sv.schema_id, sv.version)
            before = None
            if op == "u":
                before = self._payload(rng, sv.schema_id, sv.version)
            elif op == "d":
                before, after = after, None
            ev_state = state
            if self.p_stale and rng.random() < self.p_stale:
                ev_state = max(0, state - 1)
            ev = CDCEvent(
                key=pos,
                op=op,
                state=ev_state,
                schema_id=sv.schema_id,
                version=sv.version,
                before=before,
                after=after,
                ts=pos,
            )
            out.append(ev)
            # at-least-once: occasionally deliver the same event twice
            if rng.random() < self.p_duplicate and len(out) < count:
                out.append(dataclasses.replace(ev, ts=pos))
            pos += 1
        return out[:count]

    def slice_columnar(self, start: int, count: int) -> ColumnarChunk:
        """Columnar form of :meth:`slice`: the same deterministic events,
        with the payloads flattened once into (uid, value) arrays at the
        source boundary so downstream densification never walks a dict."""
        return columnarize(self.slice(start, count))

    def stream(self, start: int = 0, chunk: int = 256) -> Iterator[CDCEvent]:
        pos = start
        while True:
            for ev in self.slice(pos, chunk):
                yield ev
            pos += chunk
