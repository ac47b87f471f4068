"""Streaming Pipeline API: ``Source -> METLApp -> [RowSink, ...]``.

Counterpart of ``repro.etl.pipeline``, with the same classes, names and
semantics.  The paper's METL app sits between CDC extraction and *multiple*
consumers (DW + ML platform, SS3/SS5.5).  This module is that topology as a
library: a :class:`Pipeline` pulls event chunks from a :class:`Source`, runs
them through a :class:`~repro_torch.etl.metl.METLApp`, and fans the
canonical rows out to every attached :class:`RowSink`.  The pipeline has no
device of its own: it runs on whatever device its app runs on (the card by
default, ``METLApp(device="cpu")`` for the plain PyTorch versions).

**Columnar source contract.**  A chunk is either a legacy
``List[CDCEvent]`` or a :class:`~repro_torch.etl.events.ColumnarChunk` --
the payloads flattened ONCE at the source boundary into flat (uid, value)
arrays plus CSR event offsets.  :class:`EventChunkSource` yields columnar
chunks by default (``columnar=False`` opts back into event lists); either
form feeds ``METLApp.triage`` unchanged, and densification downstream is
pure numpy.  Sources also honour the dead-letter replay contract:
``source.reset_offset(pos)`` repositions the cursor so the stream
re-delivers deterministically from the position ``METLApp.reset_offset()``
returned -- re-slicing an :class:`EventChunkSource` regenerates the events
at the *current* registry state (the paper's "set back Kafka-offsets and
start new initial loads"), and a finished :class:`ListSource` cursor
rewinds to the chunk holding that position.

**Backpressure** is pull-based: the pipeline requests the next chunk only
when the previous one has been absorbed by every sink, and any sink
reporting ``full()`` stops the pull entirely (the slowest bounded consumer
gates the stream).  A stopped pipeline can be resumed -- ``run()`` again
after draining the sink -- without losing events: the one lookahead chunk
an async run may have triaged/densified is carried in ``self._pending`` and
mapped first on resume.

**Async consume** (``async_consume=True``) is the double buffer, cashing in
the engine protocol's explicit densify / dispatch / emit split:

    dispatch chunk N            (one C call from N's pinned host arena: it
                                 queues the copies and the launch on the
                                 device's CUDA stream and returns, with the
                                 interpreter lock released inside it)
    triage+densify chunk N+1    (host python/numpy into the OTHER arena,
                                 overlapping N's copies and kernel --
                                 including the sharded engine's per-shard
                                 routing split)
    emit chunk N                (the one sync point: the readback waits for
                                 N's kernel; by now it is usually done)
    fan out chunk N's rows

so chunk N+1's host-side densification overlaps chunk N's device work.
Triage stays strictly ordered (chunk N's dedup/parking completes before
chunk N+1's begins), which keeps async consume bit-exact with sync consume
-- same rows, same order, same stats; only the wall-clock changes.  At most
two chunks are in flight (one on the device, one densifying): that bound is
the double buffer's built-in backpressure.

**The two host arenas.**  Every engine densifies into one of two pinned
host arenas taken in turn (``etl/engines.py`` ``_HostArenas``); ``take``
waits on the CUDA event recorded behind the copies that last read the slot
it hands out, and dispatching a chunk whose slot a later densify took
raises.  The double buffer fits that bound exactly: chunk N is always
dispatched before chunk N+1 is densified, so N+1 takes the other slot, and
N+2 takes N's slot only after N's copies ran.  A lazy refresh inside N+1's
triage (its parked-event replay runs ``consume``: densify, dispatch, emit)
takes and frees a slot of its own before N+1 densifies; the ``_pending``
chunk a backpressure stop keeps holds its slot undispatched, and every
resume, sync or async, dispatches it before anything else densifies; a
control boundary emits N before the next chunk densifies.  A lookahead
deeper than one chunk would need a third arena.

With a ``device_densify=True`` engine the "densify" half shrinks to the
layout + pack pass (:class:`~repro_torch.etl.engines.ColumnarDense`): there
is NO host per-chunk scatter at all -- the raw columnar items cross to the
device in one packed copy and densification happens inside chunk N's
single fused launch, so the overlapped host work per chunk is just triage,
routing and the int32 pack.  The stage seam and the epoch pin are unchanged
(``ColumnarDense.plan``), so everything below -- async consume, control
boundaries, parked replay -- applies identically.

The double buffer is single-threaded on the host by default: the stream
already runs the device work beside the host.  ``densify_thread=True``
moves the lookahead's triage + densify onto one worker thread, which can
overlap the main thread's emit only while one of them runs native code
without the interpreter lock (the scatter, the readback's wait).  The lazy
refresh runs on the main thread first (``METLApp.ensure_ready``), the
worker's ``take`` may wait on an event and allocate pinned memory, and
the worker and the main thread's emit count disjoint ``stats`` keys.  A
failure on the worker re-raises from the future in :meth:`Pipeline.
_resolve`.  PERF.md gives the card's rates of the three modes.

**In-band control.**  :meth:`Source.poll` may interleave typed
:class:`~repro_torch.etl.control.ControlEvent`\\ s (schema evolutions,
matrix edits, freeze/thaw windows) with the data chunks -- the control
plane rides the same stream as the data, like the paper's schema-registry
workflow firing against a live CDC topic.  The pipeline applies each
control event at the chunk boundary where it arrives (single writer:
``app.coordinator.apply(event, defer_frozen=True)`` by default; a
:class:`~repro_torch.etl.cluster.Cluster` overrides ``apply_control`` so one
coordinator applies each event exactly once across N instances).  The
eviction -> lazy recompile -> parked-replay machinery downstream is exactly
the engine-protocol seam: chunks densified *before* the boundary stay
pinned to their epoch's plan (``DenseChunk.plan``), so async
double-buffered consume stays bit-exact across a mid-stream evolution --
the async loop drains its lookahead at a control boundary, which makes the
(refresh, replay, next-chunk) ordering identical to the sync path.
``EventChunkSource(control={chunk_index: event})`` injects scripted
evolutions at chunk positions; :class:`ScriptedControlSource` wraps any
source the same way.  Control events do not count against
``run(max_chunks=)`` budgets and are applied exactly once (a replay
``reset_offset`` re-delivers data, never control).

**Plan lifecycle across control boundaries.**  The recompile the boundary
triggers goes through the engine's
:class:`~repro_torch.etl.plan.PlanManager`: by default an incremental
recompaction (only the evolution's touched columns are re-lowered and
spliced into the previous epoch's fused table,
:func:`repro_torch.core.dmm_torch.recompile_columns` / ``splice_fused``),
not a full rebuild -- and with ``background=True`` the manager prepares the
next epoch on a worker thread the moment the eviction fan-out fires, so the
boundary's lazy recompile usually finds the table ready.  The epoch pin
above is exactly what lets the in-flight chunk drain on the OLD epoch's
table while the next chunk densifies against the new one; a manager bound
with ``publish=True`` records each cutover in the control log as a
:class:`~repro_torch.etl.control.PlanPublished` event.

Sinks:

  * :class:`TokenizerSink` -- feeds the serve batcher: rows -> token prompt
    lists (:func:`repro_torch.etl.batcher.tokenize_row`), optionally bounded
    (``limit=``) so a serving frontend can stop the stream once it has
    enough prompts;
  * :class:`TableSink` -- the DW stand-in: appends rows to per-business-
    entity tables, materialisable as numpy via :meth:`TableSink.to_arrays`;
  * :class:`BatcherSink` -- wraps a :class:`~repro_torch.etl.batcher.
    CanonicalBatcher`; ``full()`` once a training batch is ready, which
    makes ``pipeline.run()`` a "pull until the trainer has a batch" call;
  * :class:`CollectSink` -- plain row accumulator (tests, benchmarks).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from .batcher import CanonicalBatcher, tokenize_row
from .control import ControlEvent
from .engines import CanonicalRow
from .events import CDCEvent, ColumnarChunk, EventSource
from .metl import METLApp

Chunk = Union[List[CDCEvent], ColumnarChunk]
StreamItem = Union[Chunk, ControlEvent]
# a chunk-position -> scripted control schedule; values may be one event or
# an ordered batch of events to emit before that chunk
ControlSchedule = Dict[int, Union[ControlEvent, Sequence[ControlEvent]]]


def _pop_scheduled(
    schedule: ControlSchedule, emitted: set, key: int
) -> Sequence[ControlEvent]:
    """The exactly-once schedule pop shared by the scripted sources: the
    event(s) scheduled at ``key``, or nothing if absent / already emitted
    (a replay rewind re-delivers data, never control)."""
    evs = schedule.get(key)
    if evs is None or key in emitted:
        return ()
    emitted.add(key)
    return evs if isinstance(evs, (list, tuple)) else (evs,)

__all__ = [
    "Source",
    "EventChunkSource",
    "ListSource",
    "ScriptedControlSource",
    "RowSink",
    "TokenizerSink",
    "TableSink",
    "BatcherSink",
    "CollectSink",
    "Pipeline",
    "PipelineStats",
]


# -- sources ------------------------------------------------------------------


class Source:
    """Anything that yields CDC event chunks on demand (pull-based).

    A chunk is a ``List[CDCEvent]`` or a :class:`ColumnarChunk` (see module
    docstring).  ``reset_offset(pos)`` is the dead-letter replay contract:
    reposition the cursor so the next ``chunks()`` call re-delivers the
    stream deterministically from stream position ``pos`` (the value
    ``METLApp.reset_offset()`` returned) -- it must work on an exhausted
    cursor too, because the dead letter is typically drained after the
    stream stopped.
    """

    def chunks(self) -> Iterator[Chunk]:
        raise NotImplementedError

    def poll(self) -> Iterator[StreamItem]:
        """The in-band stream: data chunks, possibly interleaved with
        :class:`~repro_torch.etl.control.ControlEvent`\\ s.  The pipeline pulls
        through this method; the default is the plain data stream."""
        return self.chunks()

    def reset_offset(self, pos: int) -> None:
        raise NotImplementedError


class EventChunkSource(Source):
    """Chunked cursor over an :class:`~repro_torch.etl.events.EventSource` stream.

    The cursor persists across ``poll()``/``chunks()`` calls, so a pipeline
    stopped by sink backpressure resumes exactly where it left off.
    ``max_chunks`` bounds the *lifetime* pull count (None = unbounded
    stream); a :meth:`reset_offset` rewind re-aims the position-derived
    budget rather than burning extra pulls.  With ``columnar=True`` (the
    default) chunks are built columnar at the source boundary
    (:meth:`~repro_torch.etl.events.EventSource.slice_columnar`).

    ``stride``/``offset`` slice the global chunk grid deterministically for
    horizontal scaling: instance ``k`` of ``N`` takes chunk indices ``k,
    k+N, k+2N, ...`` (``stride=N, offset=k``), so the union over instances
    is exactly the single-instance chunk set and any instance can recompute
    any other's slice (the :class:`~repro_torch.etl.cluster.Cluster` contract).

    ``control`` schedules in-band control events on the *global* chunk
    grid: ``{chunk_index: event(s)}`` is emitted immediately before that
    chunk is sliced (so a scheduled evolution re-shapes the very chunk it
    precedes).  Scheduled events fire exactly once -- a replay
    :meth:`reset_offset` re-delivers data at the current state but never
    re-applies control -- and only from the source that owns the index, so
    sliced instances can all share one schedule.
    """

    def __init__(
        self,
        source: EventSource,
        *,
        start: int = 0,
        chunk_size: int = 256,
        max_chunks: Optional[int] = None,
        columnar: bool = True,
        control: Optional[ControlSchedule] = None,
        stride: int = 1,
        offset: int = 0,
    ) -> None:
        if stride < 1 or not (0 <= offset < stride):
            raise ValueError(f"need stride >= 1 and 0 <= offset < stride, "
                             f"got stride={stride} offset={offset}")
        self.source = source
        self.chunk_size = chunk_size
        self.max_chunks = max_chunks
        self.columnar = columnar
        self.control: ControlSchedule = dict(control or {})
        self.stride = stride
        self.offset = offset
        self._start = start
        self._idx = offset  # global chunk index of the next owned chunk
        self._pulled = 0
        self._control_emitted: set = set()

    @property
    def next_index(self) -> int:
        """Global chunk-grid index of the next chunk this source will pull."""
        return self._idx

    def poll(self) -> Iterator[StreamItem]:
        slicer = self.source.slice_columnar if self.columnar else self.source.slice
        while self.max_chunks is None or self._pulled < self.max_chunks:
            j = self._idx
            for ev in _pop_scheduled(self.control, self._control_emitted, j):
                yield ev
            # sliced AFTER any scheduled control applied: the generator only
            # resumes here once the pipeline consumed (and applied) the
            # control yields above, so the chunk reflects the new state
            chunk = slicer(self._start + j * self.chunk_size, self.chunk_size)
            self._idx = j + self.stride
            self._pulled += 1
            yield chunk

    def chunks(self) -> Iterator[Chunk]:
        if self.control:
            raise ValueError(
                "this source carries in-band control events; iterate poll() "
                "(chunks() would silently skip the scheduled control)"
            )
        return self.poll()  # type: ignore[return-value]

    def reset_offset(self, pos: int) -> None:
        """Rewind to the chunk-grid slice containing stream position ``pos``.

        Aligning down to the grid keeps re-slicing deterministic: the
        re-delivered chunks have exactly the boundaries the original pull
        had, so every host (and every replay) regenerates identical slices.
        On a strided source the rewind lands on the owning grid step when
        this source owns ``pos``'s chunk, else on its next owned chunk.
        """
        n = max(0, pos - self._start) // self.chunk_size
        m = max(0, -(-(n - self.offset) // self.stride))
        self._idx = self.offset + m * self.stride
        self._pulled = min(self._pulled, int(m))


class ListSource(Source):
    """A fixed, pre-materialised list of stream items (tests, benchmarks).

    Items may be data chunks or in-band :class:`ControlEvent`\\ s -- a
    scripted stream spelled out literally.  Like :class:`EventChunkSource`,
    the cursor persists across ``chunks()`` calls: a pipeline stopped by
    backpressure resumes at the next unpulled item instead of re-delivering
    from the start.  :meth:`reset_offset` rewinds a (possibly finished)
    cursor to the first chunk holding the requested stream position, so
    dead-letter replay re-delivers the same chunk objects deterministically
    (control items are never re-delivered: the rewind lands on data)."""

    def __init__(self, chunks: Sequence[StreamItem]) -> None:
        self._chunks = list(chunks)
        self._cursor = 0

    def chunks(self) -> Iterator[StreamItem]:
        while self._cursor < len(self._chunks):
            chunk = self._chunks[self._cursor]
            self._cursor += 1
            yield chunk

    @staticmethod
    def _events(chunk: StreamItem) -> List[CDCEvent]:
        if isinstance(chunk, ControlEvent):
            return []
        return chunk.events if isinstance(chunk, ColumnarChunk) else chunk

    def reset_offset(self, pos: int) -> None:
        """Rewind (even a finished cursor) to the first chunk containing an
        event at stream position >= ``pos``; no-op past the end when every
        chunk is older than ``pos``."""
        for k, chunk in enumerate(self._chunks):
            if any(ev.ts >= pos for ev in self._events(chunk)):
                self._cursor = k
                return
        self._cursor = len(self._chunks)


class ScriptedControlSource(Source):
    """Wrap ANY source, injecting scripted control events at data-chunk
    positions: ``control={k: event(s)}`` emits before the k-th data chunk
    the wrapped source delivers through this wrapper (0-based, counted
    across ``poll()`` calls).  Control the inner source already carries
    in-band passes through untouched; scheduled events fire exactly once,
    and :meth:`reset_offset` delegates to the inner source without
    re-arming them."""

    def __init__(self, inner: Source, control: ControlSchedule) -> None:
        self.inner = inner
        self.control: ControlSchedule = dict(control)
        self._count = 0  # data chunks delivered through this wrapper
        self._emitted: set = set()

    def poll(self) -> Iterator[StreamItem]:
        it = self.inner.poll()
        while True:
            for ev in _pop_scheduled(self.control, self._emitted, self._count):
                yield ev
            item = next(it, None)
            if item is None:
                return
            yield item
            if not isinstance(item, ControlEvent):
                self._count += 1

    def chunks(self) -> Iterator[Chunk]:
        if self.control:
            raise ValueError(
                "this source carries in-band control events; iterate poll()"
            )
        return self.inner.chunks()

    def reset_offset(self, pos: int) -> None:
        self.inner.reset_offset(pos)


# -- sinks --------------------------------------------------------------------


class RowSink:
    """Canonical-row consumer protocol.  ``full()`` is the backpressure
    signal: a True return stops the pipeline's pull loop."""

    def write(self, rows: List[CanonicalRow]) -> None:
        raise NotImplementedError

    def full(self) -> bool:
        return False

    def close(self) -> None:
        pass


class TokenizerSink(RowSink):
    """Feeds the serve batcher: canonical rows -> token prompt lists."""

    def __init__(self, vocab: int, *, max_len: int = 16, limit: Optional[int] = None) -> None:
        self.vocab = vocab
        self.max_len = max_len
        self.limit = limit
        self.prompts: List[List[int]] = []

    def write(self, rows: List[CanonicalRow]) -> None:
        for row in rows:
            if self.full():
                break
            self.prompts.append(tokenize_row(row, self.vocab)[: self.max_len])

    def full(self) -> bool:
        return self.limit is not None and len(self.prompts) >= self.limit


class TableSink(RowSink):
    """Data-warehouse stand-in: one append-only table per business entity."""

    def __init__(self):
        self.tables: Dict[Tuple[int, int], List[Tuple[int, np.ndarray, np.ndarray]]] = {}

    def write(self, rows: List[CanonicalRow]) -> None:
        for (rw, vals, mask, key) in rows:
            self.tables.setdefault(rw, []).append((key, vals, mask))

    def to_arrays(self) -> Dict[Tuple[int, int], Dict[str, np.ndarray]]:
        """Materialise every table: {(r, w): {keys (n,), values (n, n_out),
        mask (n, n_out)}}."""
        out = {}
        for rw, recs in self.tables.items():
            out[rw] = {
                "keys": np.asarray([k for k, _, _ in recs], np.int64),
                "values": np.stack([v for _, v, _ in recs]),
                "mask": np.stack([m for _, _, m in recs]),
            }
        return out


class BatcherSink(RowSink):
    """Feeds a :class:`CanonicalBatcher`; full once a batch is ready, so
    ``pipeline.run()`` pulls exactly until the trainer can step."""

    def __init__(self, batcher: CanonicalBatcher) -> None:
        self.batcher = batcher

    def write(self, rows: List[CanonicalRow]) -> None:
        self.batcher.add_rows(rows)

    def full(self) -> bool:
        return self.batcher.ready()


class CollectSink(RowSink):
    """Plain accumulator (tests / benchmarks)."""

    def __init__(self, limit: Optional[int] = None) -> None:
        self.rows: List[CanonicalRow] = []
        self.limit = limit

    def write(self, rows: List[CanonicalRow]) -> None:
        self.rows.extend(rows)

    def full(self) -> bool:
        return self.limit is not None and len(self.rows) >= self.limit


# -- the pipeline -------------------------------------------------------------


@dataclasses.dataclass
class PipelineStats:
    """Per-``run()`` accounting (the app's ``stats`` is cumulative)."""

    chunks: int = 0
    events: int = 0
    rows: int = 0
    control: int = 0  # in-band control events applied this run


class Pipeline:
    """``Source -> METLApp -> [RowSink, ...]`` with chunked pull, in-band
    control application at chunk boundaries, and optional double-buffered
    async consume (see module docstring)."""

    def __init__(
        self,
        source: Source,
        app: METLApp,
        sinks: Sequence[RowSink],
        *,
        async_consume: bool = False,
        densify_thread: bool = False,
        apply_control: Optional[Callable[[ControlEvent], None]] = None,
    ) -> None:
        self.source = source
        self.app = app
        self.sinks = list(sinks)
        self.async_consume = async_consume
        self.densify_thread = densify_thread
        # how in-band control events reach the single writer.  Default: this
        # pipeline's coordinator applies directly (deferring schema changes
        # that land inside a Freeze window); a Cluster passes a shared
        # applier so ONE coordinator applies each event exactly once across
        # all instances.
        self.apply_control = apply_control or (
            lambda ev: self.app.coordinator.apply(ev, defer_frozen=True)
        )
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        # lookahead chunk an async run triaged+densified but had to stop
        # before dispatching (a sink went full); mapped first on resume so
        # backpressure never loses events
        self._pending: Optional[Tuple[Chunk, object]] = None

    # -- plumbing -------------------------------------------------------------
    def _fanout(self, rows: List[CanonicalRow]) -> None:
        for sink in self.sinks:
            sink.write(rows)

    def _full(self) -> bool:
        return any(sink.full() for sink in self.sinks)

    def _prepare(self, chunk: List[CDCEvent]) -> Any:
        """Triage + densify one chunk (the host-side half of consume)."""
        return self.app.engine.densify(self.app.triage(chunk))

    # -- in-band control -------------------------------------------------------
    def _control(self, event: ControlEvent, st: PipelineStats) -> None:
        """Apply one in-band control event at a chunk boundary (single
        writer; the eviction fan-out invalidates every instance's plan and
        the next triage lazily recompiles + replays parked events)."""
        self.apply_control(event)
        st.control += 1

    def _next_data(self, it: Iterator[StreamItem], st: PipelineStats) -> Optional[Chunk]:
        """Pull the next data chunk, applying any control events in-band."""
        while True:
            item = next(it, None)
            if not isinstance(item, ControlEvent):
                return item
            self._control(item, st)

    @staticmethod
    def _budget(it: Iterator[StreamItem], pulls: int) -> Iterator[StreamItem]:
        """Stop after ``pulls`` DATA chunks.  In-band control events don't
        count against the budget, and nothing is pulled past the last
        budgeted chunk (a control event scheduled after it stays queued in
        the source for the next run)."""
        n = 0
        while n < pulls:
            item = next(it, None)
            if item is None:
                return
            yield item
            if not isinstance(item, ControlEvent):
                n += 1

    # -- run ------------------------------------------------------------------
    def run(self, *, max_chunks: Optional[int] = None) -> PipelineStats:
        """Pull until the source is exhausted, a sink reports full, or
        ``max_chunks`` data chunks have been mapped this call (in-band
        control events ride for free).  Returns this run's counters; safe
        to call repeatedly (the source cursor and any pending lookahead
        chunk persist across calls)."""
        st = PipelineStats()
        it = self.source.poll()
        if max_chunks is not None:
            # a pending lookahead chunk counts against this run's budget --
            # but only when this run can actually map it: a still-
            # backpressured resume keeps the pending parked and maps
            # nothing, and charging it anyway would under-pull the budget
            pending_maps = self._pending is not None and not self._full()
            pulls = max_chunks - (1 if pending_maps else 0)
            it = self._budget(it, max(0, pulls))
        if self.async_consume:
            self._run_async(it, st)
        else:
            self._run_sync(it, st)
        return st

    def close(self) -> None:
        self.close_worker()
        for sink in self.sinks:
            sink.close()

    def close_worker(self) -> None:
        """Join and drop the densify worker thread (if one was started),
        leaving the sinks open; a later async run starts a new one."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _prepare_ahead(self, chunk):
        """Triage + densify the lookahead chunk while the previous one is in
        flight on the device: inline by default (the CUDA stream runs the
        dispatched copies and kernel meanwhile), on the persistent worker
        thread when opted in."""
        if not self.densify_thread:
            return self._prepare(chunk)
        # do any lazy refresh (eviction -> recompile + parked replay) on the
        # MAIN thread before handing triage to the worker: the replay runs
        # dispatch/emit and would otherwise race the main thread's emit on
        # the shared stats counter
        self.app.ensure_ready()
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="metl-densify"
            )
        return self._pool.submit(self._prepare, chunk)

    @staticmethod
    def _resolve(dense):
        """The densified lookahead; a worker's failure re-raises here."""
        return dense.result() if isinstance(dense, concurrent.futures.Future) else dense

    def _account(
        self, st: PipelineStats, chunk: List[CDCEvent], rows: List[CanonicalRow]
    ) -> None:
        st.chunks += 1
        st.events += len(chunk)
        st.rows += len(rows)

    def _emit_with_replay(self, rows: List[CanonicalRow]) -> List[CanonicalRow]:
        """Prepend rows a lazy refresh replayed during triage (the staged
        path bypasses consume(), so the pipeline must drain them itself --
        replayed events are older, hence first)."""
        replayed = self.app.take_replayed()
        return replayed + rows if replayed else rows

    def _run_sync(self, it: Iterator[StreamItem], st: PipelineStats) -> None:
        engine = self.app.engine
        if self._pending is not None:  # left over from a stopped async run
            if self._full():  # still backpressured: keep it for later
                return
            chunk, dense = self._pending
            self._pending = None
            # the pending chunk was densified before the stop; its dense
            # form stays pinned to that epoch's plan even if control
            # applied in between (DenseChunk.plan)
            rows = engine.emit(engine.dispatch(dense)) if dense is not None else []
            rows = self._emit_with_replay(rows)
            self._account(st, chunk, rows)
            self._fanout(rows)
        while True:
            # check BEFORE pulling: pulling first and then breaking on a
            # full sink advanced the source cursor past a chunk that was
            # never mapped -- silently skipped events on the next run
            if self._full():
                break
            item = next(it, None)
            if item is None:
                break
            if isinstance(item, ControlEvent):
                # chunk boundary: the single writer applies, every instance
                # evicts, the next chunk's triage lazily recompiles and
                # replays parked events
                self._control(item, st)
                continue
            rows = self.app.consume(item)
            self._account(st, item, rows)
            self._fanout(rows)

    def _run_async(self, it: Iterator[StreamItem], st: PipelineStats) -> None:
        """The double buffer: chunk N is dispatched (one C call queues its
        copies and launch on the CUDA stream and returns), chunk N+1 is
        triaged + densified into the other host arena while N executes,
        then emit(N)'s readback waits for it.
        Triage order stays strictly sequential and the stages touch
        disjoint state, so the result is bit-exact with the sync path.

        An in-band control event is a buffer DRAIN point: chunk N is
        finished completely (emit + fan-out) *before* the event applies,
        and the following chunk is prepared fresh afterwards -- so the
        (apply, evict, lazy refresh, parked replay, next chunk) ordering is
        identical to the sync path and the epoch transition stays bit-exact.
        Chunks already densified keep mapping against their pinned plan."""
        engine = self.app.engine
        if self._full():
            return
        if self._pending is not None:
            chunk, dense = self._pending
            self._pending = None
        else:
            chunk = self._next_data(it, st)
            if chunk is None:
                return
            dense = self._prepare(chunk)
        handle = engine.dispatch(dense) if dense is not None else None
        while chunk is not None:
            nxt = next(it, None)
            if isinstance(nxt, ControlEvent):
                # control boundary: drain the double buffer -- finish N on
                # the old epoch, apply, then restart the overlap on the new
                rows = engine.emit(handle) if handle is not None else []
                rows = self._emit_with_replay(rows)
                self._account(st, chunk, rows)
                self._fanout(rows)
                self._control(nxt, st)
                if self._full():
                    return
                chunk = self._next_data(it, st)
                if chunk is None:
                    return
                # this triage runs the lazy refresh: recompile at the new
                # epoch + parked-event replay (drained with this chunk's
                # emit, exactly like the sync path's consume())
                dense = self._prepare(chunk)
                handle = engine.dispatch(dense) if dense is not None else None
                continue
            # the overlap: N+1's host-side densification runs while N's
            # dispatch is still in flight on device
            ahead = self._prepare_ahead(nxt) if nxt is not None else None
            rows = engine.emit(handle) if handle is not None else []
            dense_nxt = self._resolve(ahead) if ahead is not None else None
            # drain AFTER the lookahead triage completed (worker joined):
            # rows replayed by a lazy refresh during N+1's triage are
            # delivered with chunk N, i.e. still ahead of N+1's own rows
            rows = self._emit_with_replay(rows)
            self._account(st, chunk, rows)
            self._fanout(rows)
            if self._full():
                if nxt is not None:
                    # keep the lookahead (already triaged) for resume
                    self._pending = (nxt, dense_nxt)
                return
            chunk, dense = nxt, dense_nxt
            handle = engine.dispatch(dense) if dense is not None else None
