"""Spans of the program's own layers, recorded while a torch profiler records.

    with spans.span("attn.cache_read"):
        spans.note("rows", B)
        ...

A span is a named interval at a layer boundary.  Spans nest: each keeps
the index of the span open around it (its parent) and the ordinal of the
root span it runs under (its step: ``serve.step`` is the root of a
decode step, so every span of one step carries that step's id).  ``note``
attaches a count the host already knows (rows, positions, buffer rows) to
the innermost open span; it takes Python ints only, so a count never
reads a value back from the card.

Recording is on only while a torch profiler records (``torch.profiler.
profile``, or the autograd profiler it runs on): an operator who profiles
the program gets its spans with the profile, and a program that is not
profiled pays one flag read and one shared no-op ``with`` a span.  It
allocates nothing then, creates no CUDA event and never touches the card.
Nothing records under a root span that opens while the current stream is
being captured into a CUDA graph.

The spans stay out of the profiler's own event stream (no
``record_function``): a range there gets a device-side twin, which a
reader of the trace takes for a kernel, so ranges opened by the program
would change every count taken from the trace.  Instead a span keeps its
host interval on the clock the profiler stamps its events with
(``time.time_ns``), so that it can be laid beside the profiler's events,
and in a process that has initialised CUDA a pair of timing events
recorded at entry and exit on the stream that was current when its root
span opened, taken from a pool that is reused (the stream and whether it
is capturing are read once a root span: each read costs microseconds of
host time).  On the CPU the host interval stands for the device interval,
since the work runs inside the call.  A device interval covers whatever
the card did between the two events, including any time it waited for
the host to enqueue the span's work.

A stretch of spans ends when a span goes unrecorded (the profiler off) or
when the stretch is read: the next span recorded starts a fresh list, so
one process's profiled stretches never mix.  :func:`records` returns the
latest stretch's spans (or none after :func:`clear`) with their device
intervals, and :func:`summary` sums them by name.  Call either after the
card has finished the work (the caller's own ``torch.cuda.synchronize()``,
or the profiler's exit, which synchronises): neither synchronises.  Spans
are recorded by the thread that runs the decode step.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Span", "span", "note", "records", "summary", "clear"]


@dataclasses.dataclass
class Span:
    """One recorded span.  Times in ms are from the stretch's first span's
    entry on the same clock (the card's events, or the host's on the CPU);
    a span still open when read has no end and no device interval."""

    name: str
    parent: int  # index of the enclosing span in the list; -1 for a root
    step: int  # ordinal of the root span this one runs under
    host_start_ns: int  # time.time_ns(), the profiler's clock
    host_end_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_start_ms: Optional[float] = None
    device_end_ms: Optional[float] = None


class _Log:
    """The current stretch, kept in flat lists of strings and ints so that
    recording a span allocates no Python container (each would count toward
    the garbage collector's next pass, which can land inside the profiled
    steps); :func:`records` builds the :class:`Span` objects."""

    def __init__(self) -> None:
        self.pool: List[Any] = []  # CUDA events, reused by every stretch
        self.pending = ""  # the name :func:`span` hands to ``__enter__``
        self.fresh()
        self.stale = True  # the stretch has ended: the next recorded span starts a fresh one

    def fresh(self) -> None:
        self.names: List[str] = []
        self.parents: List[int] = []
        self.steps: List[int] = []
        self.starts: List[int] = []  # host ns
        self.ends: List[int] = []  # host ns, 0 while open
        self.entries: List[int] = []  # pool index of each span's entry event
        self.exits: List[int] = []  # and of its exit event, -1 while open
        self.notes: List[Any] = []  # span index, key, value, span index, key, ...
        self.open: List[int] = []
        self.roots = self.used = 0
        self.cuda = torch.cuda.is_initialized()
        self.stream: Any = None  # the stream the open root span records on
        self.stale = False

    def event(self) -> int:
        i = self.used
        if i == len(self.pool):
            self.pool.append(torch.cuda.Event(enable_timing=True))
        self.pool[i].record(self.stream)
        self.used = i + 1
        return i


_LOG = _Log()


class _Recording:
    """The one context of every span while the profiler records: spans nest,
    so the span a block closes is the innermost open one."""

    def __enter__(self) -> None:
        log = _LOG
        if log.stale:
            log.fresh()
        if log.cuda and not log.open:
            if torch.cuda.is_current_stream_capturing():
                return
            log.stream = torch.cuda.current_stream()
        i = len(log.names)
        if log.open:
            parent = log.open[-1]
            log.steps.append(log.steps[parent])
        else:
            parent = -1
            log.steps.append(log.roots)
            log.roots += 1
        log.names.append(log.pending)
        log.parents.append(parent)
        log.starts.append(time.time_ns())
        log.ends.append(0)
        log.entries.append(log.event() if log.cuda else -1)
        log.exits.append(-1)
        log.open.append(i)

    def __exit__(self, *exc: Any) -> None:
        log = _LOG
        if not log.open:  # not recorded, or recorded in a stretch that has ended
            return
        i = log.open.pop()
        if log.cuda:
            log.exits[i] = log.event()
        log.ends[i] = time.time_ns()


_OFF = nullcontext()
_ON = _Recording()


def span(name: str) -> Any:
    """A context manager that records ``name`` around its block while a
    torch profiler records, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        _LOG.stale = True
        return _OFF
    _LOG.pending = name
    return _ON


def note(key: str, value: int) -> None:
    """Attach the count ``value`` (a Python int the host knows) to the
    innermost open span, while a torch profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    log = _LOG
    if not log.open:
        return
    if not isinstance(value, int):
        raise TypeError(f"span count {key!r} must be a Python int, got {type(value).__name__}")
    log.notes.append(log.open[-1])
    log.notes.append(key)
    log.notes.append(value)


def clear() -> None:
    """Drop the recorded spans: :func:`records` returns none until the next
    stretch is recorded."""
    _LOG.fresh()
    _LOG.stale = True


def records() -> List[Span]:
    """The spans of the latest recorded stretch, in the order they opened,
    with their device intervals; the stretch ends here.  Call it once the
    card has finished their work."""
    log = _LOG
    log.stale = True
    spans = [Span(*row) for row in zip(log.names, log.parents, log.steps, log.starts, log.ends)]
    for j in range(0, len(log.notes), 3):
        i, key, value = log.notes[j:j + 3]
        spans[i].counts[key] = value
    for i, s in enumerate(spans):
        if not s.host_end_ns:
            continue
        if log.cuda:
            base = log.pool[log.entries[0]]
            s.device_start_ms = base.elapsed_time(log.pool[log.entries[i]])
            s.device_end_ms = base.elapsed_time(log.pool[log.exits[i]])
        else:
            s.device_start_ms = (s.host_start_ns - spans[0].host_start_ns) * 1e-6
            s.device_end_ms = (s.host_end_ns - spans[0].host_start_ns) * 1e-6
    return spans


def _covered(lo: float, hi: float, parts: List[Tuple[float, float]]) -> float:
    """The length of [lo, hi] that the union of ``parts`` covers."""
    total, reach = 0.0, lo
    for a, b in sorted(parts):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            total += b - a
            reach = b
    return total


def summary() -> Dict[str, Dict[str, float]]:
    """For each span name of :func:`records`: ``calls``, ``host_ms``,
    ``device_ms`` and ``device_self_ms`` (each span's device interval less
    the part its child spans cover), summed over its finished spans."""
    spans = records()
    children: Dict[int, List[Tuple[float, float]]] = {}
    for s in spans:
        if s.parent >= 0 and s.device_end_ms is not None:
            children.setdefault(s.parent, []).append((s.device_start_ms, s.device_end_ms))
    out: Dict[str, Dict[str, float]] = {}
    for i, s in enumerate(spans):
        if s.device_end_ms is None:
            continue
        dev = s.device_end_ms - s.device_start_ms
        row = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                      "device_self_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += (s.host_end_ns - s.host_start_ns) * 1e-6
        row["device_ms"] += dev
        row["device_self_ms"] += dev - _covered(s.device_start_ms, s.device_end_ms,
                                                children.get(i, []))
    return out
