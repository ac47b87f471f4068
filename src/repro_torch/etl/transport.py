"""Wire codec + in-repo transports for the replicated control plane.

The distributed coordinator (:mod:`repro_torch.etl.replication`) ships
control-log records, coordinator snapshots and canonical rows between a
leader and its follower processes.  This module is the boundary layer: a
**stable, versioned codec** (every message is plain JSON-able data stamped
with ``WIRE_VERSION``) and two dumb message movers with identical
semantics --

  :func:`local_pipe`     an in-process queue pair that still JSON round-trips
                         every message, so single-process tests genuinely
                         exercise wire serializability;
  :class:`SocketTransport`  newline-delimited JSON over a TCP socket
                         (:class:`SocketServer` accepts one per follower).

The wire is the reference's (``repro.etl.transport``) byte for byte: the
same version, event union, sorted DPM elements and row lists, so a leader
of either package can feed followers of the other.  Rows decoded by
:func:`row_from_wire` carry the JSON lists' float64 values; in-process rows
are float32.

Transports move dicts; they know nothing about roles, terms or fencing --
that is :mod:`repro_torch.etl.replication`'s job.  The interface (``send`` /
``recv(timeout)`` / ``close``, FIFO per direction) is deliberately the
subset a Kafka topic partition provides, so a broker-backed transport can
slot in behind the same calls later.

**Replayable-only contract** (see :mod:`repro_torch.etl.control`): only
``replayable`` control events may be encoded.  :func:`encode_event` rejects
anything else -- ``ClosureUpdate`` included -- with a
:class:`~repro_torch.etl.control.ControlReplayError` *before* it hits the wire,
because a follower rebuilds state exclusively by re-applying events and an
opaque closure cannot be re-applied.

FIFO ordering is load-bearing: the leader sends records before the
heartbeat that advances the data frontier past them, so "frontier >= h
received" implies "every record taking effect at or before chunk h
received" (:mod:`repro_torch.etl.replication` gates follower slicing on exactly
this).
"""

from __future__ import annotations

import dataclasses
import json
import queue
import select
import socket
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.dmm import DPM
from ..core.state import ControlRecord, StateCoordinator
from ..core.registry import Registry
from .control import (
    ControlEvent,
    ControlReplayError,
    Freeze,
    MatrixEdit,
    PlanPublished,
    SchemaAdded,
    SchemaEvolved,
    Thaw,
    VersionDeleted,
)

__all__ = [
    "WIRE_VERSION",
    "Transport",
    "TransportClosed",
    "SocketServer",
    "SocketTransport",
    "connect",
    "decode_event",
    "decode_record",
    "decode_snapshot",
    "encode_event",
    "encode_record",
    "encode_snapshot",
    "local_pipe",
    "row_from_wire",
    "row_to_wire",
]

WIRE_VERSION = 1

# The replayable control-event union; the codec is closed over it on purpose
# (an unknown type on either side is a deployment skew bug, not data).
_EVENT_TYPES = {
    cls.__name__: cls
    for cls in (
        SchemaAdded,
        SchemaEvolved,
        VersionDeleted,
        MatrixEdit,
        Freeze,
        Thaw,
        PlanPublished,
    )
}


# ---------------------------------------------------------------------------
# Codec: events, records, snapshots, rows
# ---------------------------------------------------------------------------


def _encode_dpm(dpm: DPM) -> Dict[str, List[List[int]]]:
    # BlockKey (o, v, r, w) -> "o,v,r,w"; elements sorted for a
    # deterministic encoding (frozensets have no order)
    return {
        ",".join(map(str, key)): sorted([q, p] for q, p in block)
        for key, block in dpm.items()
    }


def _decode_dpm(d: Dict[str, List[List[int]]]) -> DPM:
    return {
        tuple(map(int, key.split(","))): frozenset(
            (int(q), int(p)) for q, p in elements
        )
        for key, elements in d.items()
    }


def encode_event(event: Any) -> Dict[str, Any]:
    """Serialize one replayable :class:`ControlEvent` to plain data.

    Raises :class:`ControlReplayError` for non-replayable events
    (``ClosureUpdate``) and for types outside the control union -- the
    transport boundary rejects them cleanly instead of crashing in the
    serializer (see the replayable-only contract in :mod:`repro_torch.etl.control`).
    """
    name = type(event).__name__
    if not getattr(event, "replayable", False):
        raise ControlReplayError(
            f"{name} is not replayable and cannot cross a transport "
            "boundary; followers rebuild state by re-applying events "
            "(use typed control events, not closure updates)"
        )
    if name not in _EVENT_TYPES:
        raise ControlReplayError(f"unknown control event type: {name}")
    if isinstance(event, MatrixEdit):
        fields: Dict[str, Any] = {"dpm": _encode_dpm(event.dpm)}
    else:
        fields = dataclasses.asdict(event)
    return {"v": WIRE_VERSION, "type": name, "fields": fields}


def decode_event(d: Dict[str, Any]) -> ControlEvent:
    """Inverse of :func:`encode_event` (exact dataclass round-trip)."""
    if d.get("v") != WIRE_VERSION:
        raise ControlReplayError(
            f"wire version mismatch: got {d.get('v')!r}, speak {WIRE_VERSION}"
        )
    name = d["type"]
    cls = _EVENT_TYPES.get(name)
    if cls is None:
        raise ControlReplayError(f"unknown control event type: {name}")
    fields = dict(d["fields"])
    if cls is MatrixEdit:
        return MatrixEdit(dpm=_decode_dpm(fields["dpm"]))
    # JSON turns tuples into lists; restore the dataclass field types
    for k, v in fields.items():
        if isinstance(v, list):
            fields[k] = tuple(v)
    return cls(**fields)


def encode_record(
    rec: ControlRecord, *, term: int, at: int
) -> Dict[str, Any]:
    """Serialize one applied control record for replication.

    ``term`` is the issuing leader's fencing term; ``at`` the global chunk
    position at which the event takes effect on the data stream (followers
    gate their slicing on it -- see :mod:`repro_torch.etl.replication`).
    """
    return {
        "v": WIRE_VERSION,
        "seq": rec.seq,
        "state": rec.state,
        "term": term,
        "at": at,
        "event": encode_event(rec.event),
    }


def decode_record(d: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`encode_record`; returns
    ``{"seq", "state", "term", "at", "record"}`` with ``record`` a rebuilt
    :class:`~repro_torch.core.state.ControlRecord`."""
    if d.get("v") != WIRE_VERSION:
        raise ControlReplayError(
            f"wire version mismatch: got {d.get('v')!r}, speak {WIRE_VERSION}"
        )
    rec = ControlRecord(
        seq=int(d["seq"]), state=int(d["state"]), event=decode_event(d["event"])
    )
    return {
        "seq": rec.seq,
        "state": rec.state,
        "term": int(d["term"]),
        "at": int(d["at"]),
        "record": rec,
    }


def encode_snapshot(coordinator: StateCoordinator) -> Dict[str, Any]:
    """Serialize a coordinator's full current state as a catch-up seed.

    Carries (registry, DPM, frozen flag, global log offset): a follower
    restored from this accepts its first replicated record at exactly
    ``log_offset``.  Deferred (queued-but-unlogged) events are deliberately
    absent -- they are volatile until logged at Thaw (see
    :mod:`repro_torch.etl.control`).
    """
    snap = coordinator.snapshot()
    return {
        "v": WIRE_VERSION,
        "registry": coordinator.registry.to_dict(),
        "dpm": _encode_dpm(snap.dpm),
        "frozen": coordinator.frozen,
        "log_offset": coordinator.log_offset,
    }


def decode_snapshot(d: Dict[str, Any]) -> StateCoordinator:
    """Rebuild a coordinator from :func:`encode_snapshot` output."""
    if d.get("v") != WIRE_VERSION:
        raise ControlReplayError(
            f"wire version mismatch: got {d.get('v')!r}, speak {WIRE_VERSION}"
        )
    return StateCoordinator(
        Registry.from_dict(d["registry"]),
        _decode_dpm(d["dpm"]),
        frozen=bool(d["frozen"]),
        log_base=int(d["log_offset"]),
    )


def row_to_wire(row: Any) -> List[Any]:
    """Canonical row ``((r, w), values, mask, key)`` -> JSON-able list."""
    (r, w), values, mask, key = row
    return [
        [int(r), int(w)],
        np.asarray(values).tolist(),
        np.asarray(mask).tolist(),
        int(key),
    ]


def row_from_wire(d: List[Any]) -> Tuple[Tuple[int, int], np.ndarray, np.ndarray, int]:
    """Inverse of :func:`row_to_wire`."""
    rw, values, mask, key = d
    return (
        (int(rw[0]), int(rw[1])),
        np.asarray(values),
        np.asarray(mask),
        int(key),
    )


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class TransportClosed(ConnectionError):
    """The peer closed the connection (EOF / dead process)."""


class Transport:
    """A dumb FIFO message mover: dicts in, dicts out, per-direction order
    preserved.  The minimal surface a Kafka topic partition also provides."""

    def send(self, msg: Dict[str, Any]) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Next message, or ``None`` after ``timeout`` seconds of silence
        (``timeout=None`` blocks; ``0`` polls).  Raises
        :class:`TransportClosed` once the peer is gone AND the buffer is
        drained -- queued messages are always delivered first."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class _QueueTransport(Transport):
    """One endpoint of :func:`local_pipe`."""

    def __init__(self, out_q: "queue.Queue", in_q: "queue.Queue") -> None:
        self._out = out_q
        self._in = in_q
        self._closed = False

    def send(self, msg: Dict[str, Any]) -> None:
        if self._closed:
            raise TransportClosed("transport closed")
        # JSON round-trip on purpose: in-process tests must exercise the
        # same wire-serializability constraints the socket path does
        self._out.put(json.dumps(msg))

    def recv(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        try:
            raw = self._in.get(block=timeout != 0, timeout=timeout or None)
        except queue.Empty:
            if self._closed:
                raise TransportClosed("transport closed") from None
            return None
        if raw is None:  # peer's close marker
            self._closed = True
            raise TransportClosed("peer closed")
        return json.loads(raw)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._out.put(None)


def local_pipe() -> Tuple[Transport, Transport]:
    """A connected in-process transport pair (leader end, follower end)."""
    a: "queue.Queue" = queue.Queue()
    b: "queue.Queue" = queue.Queue()
    return _QueueTransport(a, b), _QueueTransport(b, a)


class SocketTransport(Transport):
    """Newline-delimited JSON over a connected TCP socket.

    ``recv`` select()s on the socket and maintains its own byte buffer, so a
    timeout can never lose a partially-received line (the failure mode of
    ``settimeout`` + ``readline``).
    """

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._sock.setblocking(True)
        self._buf = b""
        self._eof = False

    def send(self, msg: Dict[str, Any]) -> None:
        try:
            self._sock.sendall(json.dumps(msg).encode() + b"\n")
        except OSError as e:
            raise TransportClosed(str(e)) from e

    def recv(self, timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while b"\n" not in self._buf:
            if self._eof:
                raise TransportClosed("peer closed")
            wait = None if deadline is None else max(0.0, deadline - time.monotonic())
            ready, _, _ = select.select([self._sock], [], [], wait)
            if not ready:
                return None
            try:
                chunk = self._sock.recv(65536)
            except OSError as e:
                raise TransportClosed(str(e)) from e
            if not chunk:
                self._eof = True  # deliver buffered lines before raising
                continue
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class SocketServer:
    """Listens for follower connections; ``accept`` yields one
    :class:`SocketTransport` per follower."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()

    def accept(self, timeout: Optional[float] = None) -> Optional[SocketTransport]:
        ready, _, _ = select.select([self._srv], [], [], timeout)
        if not ready:
            return None
        sock, _ = self._srv.accept()
        return SocketTransport(sock)

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass


def connect(
    host: str, port: int, *, timeout: float = 10.0, retry_every: float = 0.05
) -> SocketTransport:
    """Dial the leader, retrying until ``timeout`` (the leader's listener
    may not be up yet when a follower process starts)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return SocketTransport(socket.create_connection((host, port), timeout=2.0))
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(retry_every)
