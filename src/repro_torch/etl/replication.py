"""Distributed control plane: a replicated ``control_log`` over processes.

The ROADMAP's distributed coordinator, built on the invariant every prior
layer locked in: the ``control_log`` *is* the replication primitive
(:func:`~repro_torch.etl.control.replay_control_log` reconstructs
registry / state / DPM bit-exactly from a seed), so distributing METL is
shipping ``ControlRecord``\\ s over a transport -- the DOD-ETL shape with
correctness proven before the network exists.

Roles
-----

One :class:`LeaderNode` owns ``StateCoordinator.apply`` -- the single
writer, now cluster-wide.  Every applied record is appended to a
term-fenced :class:`ControlLedger` and streamed to follower processes.  A
:class:`FollowerNode` never applies: it rebuilds state exclusively through
``replay_control_log(records, coordinator=...)`` (the
``single-writer-control`` analyzer rule enforces this split statically)
and acquires its own :class:`~repro_torch.etl.plan.PlanManager` epochs from
the replayed state -- plan builds are local, control is global.

Epoch fencing
-------------

Every wire record carries the issuing leader's **term**.  The ledger
rejects appends from a term older than the highest it has opened
(:class:`FencedAppendError`), and followers drop stale-term records /
heartbeats (counted in ``rejected_stale``) -- a zombie leader that kept
running through a failover cannot corrupt anyone.  :func:`elect_leader`
picks the longest-log candidate; :func:`promote` turns it into the new
term's writer.

Data-plane determinism
----------------------

Stream slices are pure in (seed, registry state, position), so row-for-row
parity with the single-process :class:`~repro_torch.etl.cluster.Cluster`
needs only *state parity at each slice*.  Wire records carry ``at`` -- the
global chunk-grid index where the event takes effect.  The leader applies
scheduled control for positions ``<= h`` before slicing its own chunk
``h`` and then heartbeats a **frontier** (no more control will appear at
positions ``<= frontier``).  A follower slices its chunk ``h`` only after
the frontier passes ``h``, first replaying the pending records with ``at
<= h`` -- FIFO transport order (records before the heartbeat that covers
them) makes the gate sound.  Because ``at`` rides the record, a follower
joining late from the seed snapshot replays the whole history with
identical slicing.

Exactly-once restart
--------------------

The leader atomically checkpoints ``(control_log offset, source offset,
rows emitted)`` (tmp + fsync + rename, the idiom of the reference's
``train/checkpoint.py``).  On restart the ledger is truncated to the
checkpointed offset, the coordinator is rebuilt by replaying it over the
deterministic seed, and the source cursor resumes at the checkpointed grid
position -- re-generated records are bit-identical (new term), and
followers deduplicate re-shipped seqs, so the merged output stream has zero
dropped and zero duplicated rows.  Deferred (queued-but-unlogged) events
are volatile by design -- exactly-once covers *applied* control; schedule-
driven entries that were deferred inside a still-open Freeze window are
re-queued deterministically from the schedule on resume.

Liveness is follower-judged: a :class:`LeaderLease` tracks heartbeat
arrivals and expires at ``factor x`` the rolling median interval (the
reference's ``train/elastic.py`` straggler-deadline shape), raising
:class:`LeaderLost` so the follower can re-subscribe or stand for election.

Run ``python -m repro_torch.etl.replication --role leader|follower|oracle``
for the multi-process runtime mode (``serve --etl --instances N
--replicated`` and ``chip_smoke.py`` drive it).

The port's data planes run on a device: every :class:`DataPlane` maps its
owned chunks on the card by default (the fused engine with host densify:
one ``segmented_gather`` launch a chunk) and raises without one;
``device="cpu"`` (``--device cpu`` on the command line) runs the plain
PyTorch versions.  Leader and follower processes may share one card, each
with its own context, plan and pinned arenas.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from statistics import median
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.state import StateCoordinator
from .control import ControlReplayError, replay_control_log
from .metl import METLApp
from .pipeline import CollectSink, ControlSchedule, EventChunkSource, Pipeline
from .transport import (
    SocketServer,
    Transport,
    TransportClosed,
    WIRE_VERSION,
    connect,
    decode_record,
    decode_snapshot,
    encode_record,
    encode_snapshot,
    row_to_wire,
)

__all__ = [
    "ControlLedger",
    "DataPlane",
    "FencedAppendError",
    "FollowerNode",
    "LeaderLease",
    "LeaderLost",
    "LeaderNode",
    "END_OF_STREAM",
    "elect_leader",
    "load_restart",
    "promote",
    "save_restart",
]

# frontier sentinel: no further data-affecting control will ever be issued
END_OF_STREAM = 1 << 62


class FencedAppendError(RuntimeError):
    """A stale-term writer tried to append (or a seq gap broke the log):
    the fencing contract rejected it."""


class LeaderLost(RuntimeError):
    """The leader's heartbeat lease expired or its transport closed; the
    follower should re-subscribe (same or newly elected leader)."""


# ---------------------------------------------------------------------------
# Atomic restart checkpoints (the train/checkpoint.py idiom, single file)
# ---------------------------------------------------------------------------


def save_restart(path: str, meta: Dict[str, Any]) -> None:
    """Atomically publish a restart checkpoint: write ``path.tmp``, fsync,
    rename.  Readers never observe a torn file; an interrupted write leaves
    the previous checkpoint intact."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_restart(path: str) -> Optional[Dict[str, Any]]:
    """The last published checkpoint, or None when none exists."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The fenced ledger
# ---------------------------------------------------------------------------


class ControlLedger:
    """Ordered store of wire-encoded control records with term fencing.

    ``base`` is the global seq of the first record (a promoted leader's
    ledger covers only its own suffix).  :meth:`open_term` is the fencing
    transition: a new leader opens a strictly higher term, after which any
    append stamped with an older term raises :class:`FencedAppendError` --
    the log-side half of the fencing story (followers independently drop
    stale-term records).  With ``path=`` every append is also written as a
    JSON line (flush + fsync) so a restarted leader can rebuild its state
    by replaying the file.
    """

    def __init__(self, base: int = 0, path: Optional[str] = None) -> None:
        self.base = base
        self.term = 0
        self._records: List[Dict[str, Any]] = []
        self._path = path

    @property
    def offset(self) -> int:
        """Global seq the next append must carry."""
        return self.base + len(self._records)

    def records(self, frm: int = 0) -> List[Dict[str, Any]]:
        """Wire records with seq >= ``frm`` (follower backfill)."""
        if frm <= self.base:
            return list(self._records)
        return self._records[frm - self.base :]

    def open_term(self, term: int) -> None:
        """Fence every older writer: only records stamped >= ``term`` may
        append from now on.  A non-advancing term is itself a stale writer."""
        if term <= self.term:
            raise FencedAppendError(
                f"term {term} is not newer than current term {self.term}: "
                "stale leader fenced"
            )
        self.term = term

    # named `commit`, not `append`: the analyzer's over-approximate call
    # graph links bare-name attribute calls, and every `list.append` on the
    # engine dispatch path would otherwise acquire a spurious edge into the
    # ledger (dragging file I/O into the host-sync rule's dispatch scope)
    def commit(self, wire: Dict[str, Any]) -> None:
        if wire["term"] < self.term:
            raise FencedAppendError(
                f"append from term {wire['term']} rejected: ledger is at "
                f"term {self.term} (stale leader fenced)"
            )
        self.term = max(self.term, wire["term"])
        if wire["seq"] != self.offset:
            raise FencedAppendError(
                f"seq gap: record {wire['seq']} != expected {self.offset}"
            )
        self._records.append(wire)
        if self._path is not None:
            with open(self._path, "a") as f:
                f.write(json.dumps(wire) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def truncate(self, to_offset: int) -> int:
        """Drop records with seq >= ``to_offset`` (restart: everything past
        the checkpoint is re-derived).  Rewrites the backing file."""
        keep = max(0, to_offset - self.base)
        dropped = len(self._records) - keep
        if dropped > 0:
            self._records = self._records[:keep]
            if self._path is not None:
                tmp = self._path + ".tmp"
                with open(tmp, "w") as f:
                    for wire in self._records:
                        f.write(json.dumps(wire) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._path)
        return max(0, dropped)

    @classmethod
    def load(cls, path: str, base: int = 0) -> "ControlLedger":
        led = cls(base=base)
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        wire = json.loads(line)
                        led._records.append(wire)
                        led.term = max(led.term, int(wire["term"]))
        led._path = path
        return led


# ---------------------------------------------------------------------------
# Heartbeat lease (the elastic.py straggler-deadline shape)
# ---------------------------------------------------------------------------


class LeaderLease:
    """Follower-side leader liveness: heartbeat intervals feed a rolling
    median, and the lease expires at ``factor x median`` (``timeout``
    until enough samples exist) -- the ``StragglerWatchdog`` deadline
    logic, repointed at the leader."""

    def __init__(
        self, *, timeout: float = 3.0, factor: float = 5.0, window: int = 32
    ) -> None:
        self.timeout = timeout
        self.factor = factor
        self._intervals: deque = deque(maxlen=window)
        self._last: Optional[float] = None

    def beat(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        if self._last is not None:
            self._intervals.append(max(1e-6, now - self._last))
        self._last = now

    def deadline(self) -> float:
        if len(self._intervals) < 4:
            return self.timeout
        return max(self.timeout, self.factor * median(self._intervals))

    def expired(self, now: Optional[float] = None) -> bool:
        if self._last is None:
            return False
        now = time.monotonic() if now is None else now
        return (now - self._last) > self.deadline()


# ---------------------------------------------------------------------------
# Data plane: one stride slot of the shared chunk grid
# ---------------------------------------------------------------------------


def _no_inband_control(event: Any) -> None:
    raise RuntimeError(
        "replicated data planes carry no in-band control: the leader drives "
        "the schedule and followers replay the replicated log"
    )


class DataPlane:
    """One stride slot of the global chunk grid, stepped one owned chunk at
    a time.

    The replicated runtime splits control from data: this plane's source
    carries NO in-band control schedule (the leader applies control
    directly and replicates it; followers replay).  ``skip_chunks`` resumes
    a restarted node past its already-emitted chunks without re-pulling
    them (the grid-aligned ``reset_offset`` contract keeps the re-sliced
    boundaries identical).  The plane maps on ``device`` (the card when
    None; raises without one)."""

    def __init__(
        self,
        coordinator: StateCoordinator,
        stream: Any,
        *,
        slot: int = 0,
        instances: int = 1,
        start: int = 0,
        chunk_size: int = 64,
        max_chunks: Optional[int] = None,
        engine: Any = "fused",
        columnar: bool = True,
        sinks: Sequence[Any] = (),
        skip_chunks: int = 0,
        device: Any = None,
    ) -> None:
        quota = (
            None
            if max_chunks is None
            else max(0, (max_chunks - slot + instances - 1) // instances)
        )
        if quota is not None:
            quota = max(0, quota - skip_chunks)
        self.collect = CollectSink()
        self.source = EventChunkSource(
            stream,
            start=start,
            chunk_size=chunk_size,
            max_chunks=quota,
            columnar=columnar,
            stride=instances,
            offset=slot,
        )
        if skip_chunks:
            self.source.reset_offset(
                start + (slot + skip_chunks * instances) * chunk_size
            )
        self.app = METLApp(coordinator, engine=engine, device=device)
        self.pipe = Pipeline(
            self.source,
            self.app,
            [self.collect, *sinks],
            apply_control=_no_inband_control,
        )
        self._seen = 0

    @property
    def next_index(self) -> int:
        """Global grid index of the next chunk this plane will slice."""
        return self.source.next_index

    def step(self) -> Optional[Tuple[int, List[Any]]]:
        """Map one owned chunk; returns ``(global index, rows)`` or None
        when the quota is exhausted."""
        h = self.source.next_index
        st = self.pipe.run(max_chunks=1)
        if st.chunks == 0:
            return None
        rows = self.collect.rows[self._seen :]
        self._seen = len(self.collect.rows)
        return h, rows


def _normalize_schedule(
    control: Optional[ControlSchedule],
) -> List[Tuple[int, Tuple[Any, ...]]]:
    out: List[Tuple[int, Tuple[Any, ...]]] = []
    for idx in sorted(control or {}):
        evs = (control or {})[idx]
        out.append((idx, tuple(evs) if isinstance(evs, (list, tuple)) else (evs,)))
    return out


# ---------------------------------------------------------------------------
# Leader
# ---------------------------------------------------------------------------


class LeaderNode:
    """The cluster-wide single writer for one fencing term.

    Owns ``StateCoordinator.apply``: every applied record is appended to
    the term-fenced :class:`ControlLedger` and broadcast to subscribed
    followers, stamped with ``(term, at)``.  The coordinator's
    ``replication_info()`` keys report ``role="leader"`` / this term.
    """

    role = "leader"
    lag_records = 0  # the leader is, definitionally, caught up

    def __init__(
        self,
        coordinator: StateCoordinator,
        *,
        term: int = 1,
        node_id: int = 0,
        ledger: Optional[ControlLedger] = None,
        checkpoint_path: Optional[str] = None,
    ) -> None:
        self.coordinator = coordinator
        self.node_id = node_id
        self.ledger = ledger if ledger is not None else ControlLedger(
            base=coordinator.log_offset
        )
        if self.ledger.offset != coordinator.log_offset:
            raise FencedAppendError(
                f"ledger offset {self.ledger.offset} != coordinator log "
                f"offset {coordinator.log_offset}: wrong ledger for this state"
            )
        self.ledger.open_term(term)
        self.term = term
        self.checkpoint_path = checkpoint_path
        # the seed followers catch up from: joined with the ledger's record
        # suffix it reconstructs the full current state (and, because ``at``
        # rides each record, the full data-plane slicing history)
        self.seed = encode_snapshot(coordinator)
        self.followers: List[Transport] = []
        self.follower_offsets: Dict[int, int] = {}
        self.follower_rows: Dict[int, int] = {}
        self._done: Dict[int, Dict[str, Any]] = {}
        self._shipped = len(coordinator.control_log)
        self._sched: List[Tuple[int, Tuple[Any, ...]]] = []
        self._sp = 0
        self.position = 0  # global data-grid cursor (for out-of-band stamps)
        self.frontier = -1
        self.rows_emitted = 0
        coordinator.replication = self

    # -- membership -----------------------------------------------------------
    def attach(self, transport: Transport, *, timeout: float = 10.0) -> int:
        """Accept one follower: read its ``sub``, reply ``hello`` (seed
        snapshot for a cold join, plain backfill for a resume), backfill
        the ledger suffix past what it already holds."""
        sub = transport.recv(timeout)
        if sub is None or sub.get("t") != "sub":
            raise TransportClosed(f"expected sub handshake, got {sub!r}")
        node = int(sub.get("node", -1))
        have = int(sub.get("have", -1))
        hello: Dict[str, Any] = {
            "t": "hello",
            "v": WIRE_VERSION,
            "term": self.term,
            "log_offset": self.coordinator.log_offset,
            "frontier": self.frontier,
        }
        if have < self.ledger.base:
            hello["snapshot"] = self.seed
            have = self.ledger.base
        transport.send(hello)
        for wire in self.ledger.records(frm=have):
            transport.send({"t": "rec", **wire})
        self.followers.append(transport)
        self.follower_offsets.setdefault(node, have)
        self.heartbeat()
        return node

    def _broadcast(self, msg: Dict[str, Any]) -> None:
        live = []
        for t in self.followers:
            try:
                t.send(msg)
                live.append(t)
            except TransportClosed:
                continue
        self.followers = live

    # -- the single write path ------------------------------------------------
    def apply(self, event: Any, *, at: Optional[int] = None, defer_frozen: bool = False):
        """Apply one control event and replicate every record it produced
        (a Thaw re-admits deferred events: one apply, several records, all
        stamped at the thaw's grid position)."""
        snap = self.coordinator.apply(event, defer_frozen=defer_frozen)
        self._ship(at)
        return snap

    def _ship(self, at: Optional[int] = None) -> int:
        stamp = self.position if at is None else at
        log = self.coordinator.control_log
        new = log[self._shipped :]
        for rec in new:
            wire = encode_record(rec, term=self.term, at=stamp)
            self.ledger.commit(wire)
            self._broadcast({"t": "rec", **wire})
        self._shipped = len(log)
        return len(new)

    def heartbeat(self) -> None:
        self._broadcast(
            {
                "t": "hb",
                "term": self.term,
                "frontier": self.frontier,
                "log_offset": self.coordinator.log_offset,
            }
        )

    # -- scheduled control ----------------------------------------------------
    def set_schedule(
        self,
        control: Optional[ControlSchedule],
        *,
        applied_to: Optional[int] = None,
        redefer_from: Optional[int] = None,
    ) -> None:
        """Install the global control schedule ``{chunk_index: event(s)}``.

        On a restart, ``applied_to`` skips entries the replayed log already
        contains (every entry at grid index <= ``applied_to``).  Entries in
        a still-open Freeze window (index >= ``redefer_from``) were
        deferred -- volatile, never logged -- so they are re-queued from
        the schedule instead of skipped (schedule-driven control is
        durable by determinism)."""
        self._sched = _normalize_schedule(control)
        self._sp = 0
        if applied_to is not None:
            while self._sp < len(self._sched) and self._sched[self._sp][0] <= applied_to:
                idx, evs = self._sched[self._sp]
                self._sp += 1
                if redefer_from is not None and idx >= redefer_from:
                    for ev in evs:
                        if getattr(ev, "op", None) in ("schema", "matrix"):
                            self.apply(ev, at=idx, defer_frozen=True)
        self._advance_frontier()

    def _advance_frontier(self) -> None:
        self.frontier = (
            self._sched[self._sp][0] - 1
            if self._sp < len(self._sched)
            else END_OF_STREAM
        )

    def advance(self, h: int) -> None:
        """Apply all scheduled control at grid positions <= ``h`` (stamped
        with their scheduled position), then move the frontier and
        heartbeat -- the records travel BEFORE the heartbeat that covers
        them, which is what makes the follower gate sound."""
        self.position = h
        while self._sp < len(self._sched) and self._sched[self._sp][0] <= h:
            idx, evs = self._sched[self._sp]
            self._sp += 1
            for ev in evs:
                self.apply(ev, at=idx, defer_frozen=True)
        self._advance_frontier()
        self.heartbeat()

    # -- follower feedback ----------------------------------------------------
    def pump(self, timeout: float = 0.0) -> None:
        """Drain follower acks (non-blocking by default)."""
        for t in list(self.followers):
            while True:
                try:
                    msg = t.recv(timeout)
                except TransportClosed:
                    break
                if msg is None:
                    break
                if msg.get("t") in ("ack", "done"):
                    node = int(msg.get("node", -1))
                    self.follower_offsets[node] = int(msg.get("log_offset", 0))
                    self.follower_rows[node] = int(msg.get("rows", 0))
                    if msg["t"] == "done":
                        self._done[node] = msg

    # -- restart checkpoints --------------------------------------------------
    def checkpoint(self, *, source_offset: int, chunks_done: int) -> None:
        """Atomically publish the (control_log offset, source offset) pair
        plus output accounting -- the exactly-once restart anchor."""
        if self.checkpoint_path is None:
            return
        save_restart(
            self.checkpoint_path,
            {
                "term": self.term,
                "log_offset": self.coordinator.log_offset,
                "source_offset": source_offset,
                "chunks_done": chunks_done,
                "rows_emitted": self.rows_emitted,
            },
        )

    # -- stream driving -------------------------------------------------------
    def run(
        self,
        plane: DataPlane,
        *,
        on_chunk: Optional[Callable[[int, List[Any]], None]] = None,
        checkpoint_every: Optional[int] = None,
        chunks_done: int = 0,
    ) -> int:
        """Drive the leader's own data slot to quota exhaustion, applying
        scheduled control ahead of each owned chunk.  Returns the number of
        chunks mapped this call."""
        mapped = 0
        while True:
            h = plane.next_index
            self.advance(h)
            out = plane.step()
            if out is None:
                break
            h, rows = out
            self.rows_emitted += len(rows)
            if on_chunk is not None:
                on_chunk(h, rows)
            mapped += 1
            chunks_done += 1
            self.pump(0.0)
            if checkpoint_every and chunks_done % checkpoint_every == 0:
                self.checkpoint(
                    source_offset=plane.next_index, chunks_done=chunks_done
                )
        return mapped

    def finish(
        self,
        *,
        end: Optional[int] = None,
        wait_done: bool = False,
        timeout: float = 30.0,
    ) -> None:
        """Apply any remaining scheduled control (entries at grid positions
        <= ``end``), release the frontier to the end-of-stream sentinel,
        send ``eof``, and optionally wait for every follower's ``done``."""
        if end is not None:
            self.advance(end)
        self.frontier = END_OF_STREAM
        self.heartbeat()
        self._broadcast({"t": "eof", "term": self.term})
        if wait_done:
            deadline = time.monotonic() + timeout
            want = set(self.follower_offsets)
            while set(self._done) < want and time.monotonic() < deadline:
                self.pump(0.1)

    def close(self) -> None:
        for t in self.followers:
            t.close()
        self.followers = []


# ---------------------------------------------------------------------------
# Follower
# ---------------------------------------------------------------------------


class FollowerNode:
    """A replica: subscribes to the leader, buffers replicated records, and
    advances its coordinator ONLY through ``replay_control_log`` as its
    data cursor passes each record's ``at`` position.

    Stale-term records and heartbeats are dropped (``rejected_stale``);
    duplicate seqs (a restarted leader re-shipping past the checkpoint) are
    deduplicated; a seq gap raises :class:`ControlReplayError`.  The
    coordinator's ``replication_info()`` keys report ``role="follower"``,
    the leader's term, and ``lag_records`` (received but not yet applied).
    """

    role = "follower"

    def __init__(
        self,
        transport: Transport,
        *,
        node_id: int = 1,
        coordinator: Optional[StateCoordinator] = None,
        lease: Optional[LeaderLease] = None,
    ) -> None:
        self.transport = transport
        self.node_id = node_id
        self.coordinator = coordinator
        self.lease = lease or LeaderLease()
        self.term = 0
        self.frontier = -1
        self.pending: List[Dict[str, Any]] = []
        self.rejected_stale = 0
        self.eof = False
        self.rows_emitted = 0
        if coordinator is not None:
            coordinator.replication = self

    @property
    def lag_records(self) -> int:
        """Records received from the leader but not yet applied."""
        return len(self.pending)

    # -- membership -----------------------------------------------------------
    def subscribe(self, *, timeout: float = 10.0) -> None:
        """Handshake: announce what we hold; adopt the hello's term and --
        on a cold join -- its seed snapshot.  Safe to call again after a
        failover (the new leader backfills past ``have`` and duplicate
        seqs are dropped)."""
        have = self.coordinator.log_offset if self.coordinator is not None else -1
        have += len(self.pending)
        self.transport.send(
            {"t": "sub", "v": WIRE_VERSION, "node": self.node_id, "have": have}
        )
        deadline = time.monotonic() + timeout
        while True:
            msg = self.transport.recv(max(0.0, deadline - time.monotonic()))
            if msg is None:
                raise LeaderLost("no hello before timeout")
            if msg.get("t") == "hello":
                break
            # late frames from a previous leader may still be queued
            self._dispatch(msg)
        if int(msg["term"]) < self.term:
            self.rejected_stale += 1
            raise FencedAppendError(
                f"hello from stale term {msg['term']} (follower at {self.term})"
            )
        self.term = int(msg["term"])
        if msg.get("snapshot") is not None:
            self.coordinator = decode_snapshot(msg["snapshot"])
            self.coordinator.replication = self
            self.pending = []
        if self.coordinator is None:
            raise ControlReplayError(
                "cold subscribe got no snapshot: cannot seed a replica"
            )
        self.eof = False
        self.lease = LeaderLease(
            timeout=self.lease.timeout, factor=self.lease.factor
        )
        self.lease.beat()

    # -- inbound plumbing ------------------------------------------------------
    def _dispatch(self, msg: Dict[str, Any]) -> None:
        kind = msg.get("t")
        if kind == "rec":
            if int(msg["term"]) < self.term:
                self.rejected_stale += 1
                return
            self.term = max(self.term, int(msg["term"]))
            d = decode_record(msg)
            expected = self.coordinator.log_offset + len(self.pending)
            if d["seq"] < expected:
                return  # duplicate: a restarted leader re-shipped the suffix
            if d["seq"] > expected:
                raise ControlReplayError(
                    f"replication gap: record seq {d['seq']} != expected "
                    f"{expected}"
                )
            self.pending.append(d)
        elif kind == "hb":
            if int(msg["term"]) < self.term:
                self.rejected_stale += 1
                return
            self.term = max(self.term, int(msg["term"]))
            self.frontier = max(self.frontier, int(msg["frontier"]))
            self.lease.beat()
        elif kind == "eof":
            if int(msg.get("term", self.term)) >= self.term:
                self.eof = True
                self.frontier = END_OF_STREAM

    def pump(self, timeout: float = 0.0) -> None:
        """Drain the transport (first recv honours ``timeout``, the rest
        poll)."""
        wait = timeout
        while True:
            msg = self.transport.recv(wait)
            if msg is None:
                return
            self._dispatch(msg)
            wait = 0.0

    # -- state advancement (replay only) --------------------------------------
    def advance_to(self, h: int) -> int:
        """Apply the contiguous pending prefix with ``at <= h`` through
        ``replay_control_log`` -- the ONLY way follower state moves.  The
        shared coordinator object means registered evict hooks (the METL
        app's lazy-recompile machinery) fire exactly as the leader's did."""
        due = []
        while self.pending and self.pending[0]["at"] <= h:
            due.append(self.pending.pop(0)["record"])
        if due:
            replay_control_log(due, coordinator=self.coordinator)
        return len(due)

    def wait_frontier(self, h: int, *, timeout: float = 60.0) -> None:
        """Block until the leader's frontier passes ``h`` (all control at
        positions <= ``h`` is guaranteed received, by FIFO order)."""
        deadline = time.monotonic() + timeout
        while self.frontier < h and not self.eof:
            self.pump(0.05)
            if self.lease.expired():
                raise LeaderLost(
                    f"leader heartbeat lease expired waiting for frontier {h}"
                )
            if time.monotonic() > deadline:
                raise LeaderLost(f"timed out waiting for frontier {h}")

    # -- outbound -------------------------------------------------------------
    def ack(self, *, done: bool = False) -> None:
        self.transport.send(
            {
                "t": "done" if done else "ack",
                "node": self.node_id,
                "log_offset": self.coordinator.log_offset,
                "rows": self.rows_emitted,
            }
        )

    # -- stream driving -------------------------------------------------------
    def run(
        self,
        plane: DataPlane,
        *,
        on_chunk: Optional[Callable[[int, List[Any]], None]] = None,
        frontier_timeout: float = 60.0,
    ) -> int:
        """Drive this follower's data slot to quota exhaustion, gating
        every slice on the replicated frontier.  Raises :class:`LeaderLost`
        on lease expiry / transport death -- re-``subscribe`` (the plane's
        cursor persists) and call again."""
        mapped = 0
        while True:
            h = plane.next_index
            try:
                self.wait_frontier(h, timeout=frontier_timeout)
            except TransportClosed as e:
                raise LeaderLost(str(e)) from e
            self.advance_to(h)
            out = plane.step()
            if out is None:
                break
            h, rows = out
            self.rows_emitted += len(rows)
            if on_chunk is not None:
                on_chunk(h, rows)
            mapped += 1
            try:
                self.ack()
            except TransportClosed as e:
                raise LeaderLost(str(e)) from e
        return mapped

    def finish(self, *, timeout: float = 30.0) -> None:
        """Drain the stream tail: wait for ``eof``, apply every remaining
        pending record, send the final ``done`` ack."""
        deadline = time.monotonic() + timeout
        while not self.eof:
            try:
                self.pump(0.05)
            except TransportClosed as e:
                raise LeaderLost(str(e)) from e
            if self.lease.expired():
                raise LeaderLost("leader lost before eof")
            if time.monotonic() > deadline:
                raise LeaderLost("timed out waiting for eof")
        self.advance_to(END_OF_STREAM)
        try:
            self.ack(done=True)
        except TransportClosed:
            pass


# ---------------------------------------------------------------------------
# Election / promotion
# ---------------------------------------------------------------------------


def elect_leader(candidates: Sequence[FollowerNode]) -> FollowerNode:
    """Longest-log wins (received-but-unapplied records count); node id
    breaks ties deterministically."""
    if not candidates:
        raise ValueError("no candidates")
    return max(
        candidates,
        key=lambda f: (f.coordinator.log_offset + f.lag_records, f.node_id),
    )


def promote(follower: FollowerNode, *, term: int) -> LeaderNode:
    """Turn an elected follower into the new term's single writer.

    Its pending (received-but-unapplied) records are replayed first --
    longest-log-wins includes the unapplied suffix -- then a fresh ledger
    opens at the new, strictly higher term; the old leader is fenced from
    that moment."""
    if term <= follower.term:
        raise FencedAppendError(
            f"promotion term {term} is not newer than follower term "
            f"{follower.term}"
        )
    if follower.pending:
        replay_control_log(
            [d["record"] for d in follower.pending], coordinator=follower.coordinator
        )
        follower.pending = []
    coord = follower.coordinator
    coord.replication = None
    return LeaderNode(coord, term=term, node_id=follower.node_id)


# ---------------------------------------------------------------------------
# Multi-process runtime (the CLI: leader / follower / oracle roles)
# ---------------------------------------------------------------------------


def _fixture(args):
    """The deterministic scenario every process rebuilds identically: the
    seed registry/DPM, the CDC stream, and the churn schedule (with an
    optional Freeze/Thaw window) -- determinism IS the shared config."""
    from ..core.synthetic import ScenarioConfig, build_scenario, churn_schedule

    sc = build_scenario(
        ScenarioConfig(
            n_schemas=args.schemas, versions_per_schema=2, seed=args.seed
        )
    )
    schedule: Dict[int, Any] = {}
    if args.churn:
        churn = churn_schedule(
            sc.registry,
            steps=args.churn,
            first_chunk=args.churn_first,
            every=args.churn_every,
            seed=args.seed + 1,
        )
        for idx, ev in churn.items():
            schedule.setdefault(idx, []).append(ev)
    if args.freeze_at is not None and args.thaw_at is not None:
        from .control import Freeze, Thaw

        schedule.setdefault(args.freeze_at, []).insert(0, Freeze())
        schedule.setdefault(args.thaw_at, []).append(Thaw())
    return sc, schedule


def _open_window_start(wires: Sequence[Dict[str, Any]]) -> Optional[int]:
    """Grid position of the last Freeze without a later Thaw, or None."""
    start = None
    for wire in wires:
        kind = wire["event"]["type"]
        if kind == "Freeze":
            start = int(wire["at"])
        elif kind == "Thaw":
            start = None
    return start


def _truncate_rows_file(path: str, keep_chunks: int) -> None:
    """Exactly-once output: drop row lines past the checkpoint (a crash
    between emit and checkpoint would otherwise duplicate the tail)."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    if len(lines) > keep_chunks:
        with open(path, "w") as f:
            f.writelines(lines[:keep_chunks])
            f.flush()
            os.fsync(f.fileno())


def _chunk_writer(path: str, mode: str = "a"):
    fh = open(path, mode)

    def write(h: int, rows: List[Any]) -> None:
        fh.write(
            json.dumps({"chunk": h, "rows": [row_to_wire(r) for r in rows]}) + "\n"
        )
        fh.flush()

    return write, fh


def _run_leader(args) -> int:
    sc, schedule = _fixture(args)
    from ..core.state import StateCoordinator as _Coordinator
    from .events import EventSource

    resume = args.resume and load_restart(args.checkpoint) is not None
    if resume:
        ck = load_restart(args.checkpoint)
        ledger = ControlLedger.load(args.ledger)
        ledger.truncate(int(ck["log_offset"]))
        records = [decode_record(w)["record"] for w in ledger.records()]
        coord = replay_control_log(records, sc.registry, sc.dpm)
        chunks_done = int(ck["chunks_done"])
        _truncate_rows_file(args.out, chunks_done)
        leader = LeaderNode(
            coord,
            term=int(ck["term"]) + 1,
            ledger=ledger,
            checkpoint_path=args.checkpoint,
        )
        leader.rows_emitted = int(ck["rows_emitted"])
        last_h = int(ck["source_offset"]) - args.instances
        leader.set_schedule(
            schedule,
            applied_to=last_h,
            redefer_from=_open_window_start(ledger.records()),
        )
        out_mode = "a"
    else:
        coord = _Coordinator(sc.registry, sc.dpm)
        ledger = ControlLedger(path=args.ledger) if args.ledger else None
        leader = LeaderNode(
            coord, term=1, ledger=ledger, checkpoint_path=args.checkpoint
        )
        leader.set_schedule(schedule)
        chunks_done = 0
        out_mode = "w"

    srv = SocketServer(port=args.port)
    print(f"leader: term {leader.term} listening on {srv.port}", flush=True)
    deadline = time.monotonic() + 60.0
    subscribed = 0
    while subscribed < args.followers:
        t = srv.accept(timeout=0.5)
        if t is not None:
            node = leader.attach(t)
            subscribed += 1
            print(f"leader: follower {node} subscribed", flush=True)
        else:
            # keep already-attached followers' leases alive while the rest
            # of the quorum connects (after a restart they race back in)
            leader.heartbeat()
        if time.monotonic() > deadline:
            raise TransportClosed("follower never connected")

    plane = DataPlane(
        coord,
        EventSource(coord.registry, seed=args.stream_seed),
        slot=0,
        instances=args.instances,
        chunk_size=args.chunk_size,
        max_chunks=args.max_chunks,
        skip_chunks=chunks_done,
        device=args.device,
    )
    write, fh = _chunk_writer(args.out, out_mode)
    crash_at = args.crash_after_chunks
    emitted = chunks_done

    def on_chunk(h: int, rows: List[Any]) -> None:
        nonlocal emitted
        write(h, rows)
        emitted += 1
        if crash_at is not None and emitted >= crash_at:
            # fault injection for the CI smoke: die AFTER emitting the
            # chunk but BEFORE its checkpoint -- restart must truncate the
            # orphaned output line and re-derive it bit-exactly
            os._exit(17)

    # reconnect window: a restarted leader accepts re-subscriptions that
    # arrive while it drives the stream
    def accept_pending() -> None:
        t = srv.accept(timeout=0.0)
        if t is not None:
            leader.attach(t)

    chunks_before = chunks_done
    while True:
        accept_pending()
        got = leader.run(
            plane, on_chunk=on_chunk, checkpoint_every=1, chunks_done=chunks_done
        )
        chunks_done += got
        if got == 0:
            break
    leader.finish(
        end=(args.max_chunks - 1) if args.max_chunks else None,
        wait_done=args.followers > 0,
    )
    leader.checkpoint(source_offset=plane.next_index, chunks_done=chunks_done)
    fh.close()
    info = coord.replication_info()
    print(
        f"leader: done -- {chunks_done - chunks_before} chunks this run, "
        f"{leader.rows_emitted} rows total, log_offset {info['log_offset']}, "
        f"term {info['term']}, follower rows {dict(leader.follower_rows)}",
        flush=True,
    )
    leader.close()
    srv.close()
    return 0


def _resubscribe(fol: FollowerNode, args, *, timeout: float = 120.0) -> None:
    """Reconnect until a live leader answers the ``sub`` handshake.  A
    connect can land in a *dying* leader's accept backlog and be RST mid-
    handshake, so ``TransportClosed`` here means retry, not fail."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            fol.transport.close()
        except Exception:
            pass
        try:
            fol.transport = connect(
                args.host, args.port,
                timeout=max(0.1, deadline - time.monotonic()),
            )
            fol.subscribe()
            return
        # LeaderLost covers a leader that accepted the TCP connect but is
        # too busy to answer the sub handshake yet (e.g. mid-compile)
        except (TransportClosed, LeaderLost) as e:
            if time.monotonic() > deadline:
                raise LeaderLost(f"no leader reappeared: {e}") from e
            time.sleep(0.1)


def _run_follower(args) -> int:
    # no fixture build: the replica is seeded entirely by the leader's
    # snapshot + record stream (state) and the shared stream seed (data)
    from .events import EventSource

    transport = connect(args.host, args.port, timeout=30.0)
    # a real leader crash closes the socket and surfaces instantly as
    # TransportClosed; the lease only guards a *hung* leader, so its floor
    # must ride out a leader stalled in its first chunk (the card's context
    # and kernel library loading)
    fol = FollowerNode(
        transport, node_id=args.slot, lease=LeaderLease(timeout=60.0)
    )
    try:
        fol.subscribe()
    except (TransportClosed, LeaderLost):
        _resubscribe(fol, args)
    plane = DataPlane(
        fol.coordinator,
        EventSource(fol.coordinator.registry, seed=args.stream_seed),
        slot=args.slot,
        instances=args.instances,
        chunk_size=args.chunk_size,
        max_chunks=args.max_chunks,
        device=args.device,
    )
    write, fh = _chunk_writer(args.out, "w")
    while True:
        try:
            fol.run(plane, on_chunk=write)
            fol.finish()
            break
        except LeaderLost as e:
            print(f"follower {args.slot}: leader lost ({e}); reconnecting",
                  flush=True)
            _resubscribe(fol, args)
    fh.close()
    info = fol.coordinator.replication_info()
    print(
        f"follower {args.slot}: done -- {fol.rows_emitted} rows, "
        f"log_offset {info['log_offset']}, term {info['term']}, "
        f"stale rejected {fol.rejected_stale}",
        flush=True,
    )
    return 0


def _run_oracle(args) -> int:
    """The single-process reference: one unsliced plane, the same schedule
    driven through the same leader code path (the Cluster parity suite
    pins that equivalence separately)."""
    sc, schedule = _fixture(args)
    from ..core.state import StateCoordinator as _Coordinator
    from .events import EventSource

    coord = _Coordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    leader.set_schedule(schedule)
    plane = DataPlane(
        coord,
        EventSource(coord.registry, seed=args.stream_seed),
        slot=0,
        instances=1,
        chunk_size=args.chunk_size,
        max_chunks=args.max_chunks,
        device=args.device,
    )
    write, fh = _chunk_writer(args.out, "w")
    leader.run(plane, on_chunk=write)
    leader.finish(end=(args.max_chunks - 1) if args.max_chunks else None)
    fh.close()
    print(f"oracle: {leader.rows_emitted} rows", flush=True)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="replicated control-plane runtime (leader/follower/oracle)"
    )
    ap.add_argument("--role", choices=("leader", "follower", "oracle"),
                    required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--slot", type=int, default=0,
                    help="this node's stride slot on the chunk grid")
    ap.add_argument("--instances", type=int, default=1)
    ap.add_argument("--followers", type=int, default=0,
                    help="leader: subscriptions to wait for before streaming")
    ap.add_argument("--max-chunks", type=int, default=12)
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--schemas", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--stream-seed", type=int, default=7)
    ap.add_argument("--churn", type=int, default=3,
                    help="scheduled schema evolutions on the grid")
    ap.add_argument("--churn-first", type=int, default=2)
    ap.add_argument("--churn-every", type=int, default=3)
    ap.add_argument("--freeze-at", type=int, default=None)
    ap.add_argument("--thaw-at", type=int, default=None)
    ap.add_argument("--out", default="rows.jsonl",
                    help="per-chunk canonical-row JSONL")
    ap.add_argument("--ledger", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="leader: restart from the checkpointed "
                         "(control_log offset, source offset) pair")
    ap.add_argument("--device", default="cuda",
                    help="where this node's data plane maps: cuda (the "
                         "default; the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--crash-after-chunks", type=int, default=None,
                    help="leader fault injection: _exit(17) after emitting "
                         "this many chunks, before their checkpoint")
    args = ap.parse_args(argv)

    if args.role == "leader":
        return _run_leader(args)
    if args.role == "follower":
        return _run_follower(args)
    return _run_oracle(args)


if __name__ == "__main__":
    raise SystemExit(main())
