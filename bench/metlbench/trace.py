"""The traced stretch: ``torch.profiler`` over a few steady steps after the
measured window, with ranges opened from outside the program around the
functions the per-layer readers name, and the raw trace reduced to device
time by kernel, device time by range, the device's busy union and its idle
gaps by what the host was doing.

The reduction reads the profiler's raw event list (parsing it through
``key_averages`` costs ~0.3 ms an event).  A kernel belongs to a range when
the operator that launched it started inside one of the range's intervals.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

RANGE = "bench."  # every range this module opens starts with it
STRETCH = "bench.stretch"


def _target(spec: str):
    """``"package.module:attr"`` -> (module, attr)."""
    mod, attr = spec.split(":")
    return importlib.import_module(mod), attr


@contextlib.contextmanager
def patched(ranges: Dict[str, str], probes: Dict[str, Callable]):
    """Inside the block each function of ``ranges`` ({range name: target})
    runs inside a ``record_function`` range of that name, and each function
    of ``probes`` ({target: hook}) first calls ``hook(*args, **kwargs)``.
    The module attribute is replaced, so the name must be the one the
    caller looks up (``models.model:attention_decode``, not the defining
    module's)."""
    from torch.profiler import record_function

    saved = []

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    def probed(hook, fn):
        def call(*args, **kwargs):
            hook(*args, **kwargs)
            return fn(*args, **kwargs)
        return call

    try:  # a probe runs outside the range, so its work is not the range's
        for name, spec in ranges.items():
            mod, attr = _target(spec)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, ranged(name, getattr(mod, attr)))
        for spec, hook in probes.items():
            mod, attr = _target(spec)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, probed(hook, getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


class Stretch:
    """One profiled stretch: call :meth:`record` around the steps (ending
    in a device sync), then read the reductions."""

    def __init__(self, device: torch.device):
        self.device = device
        self.steps = 0
        self.device_ops: Dict[str, Tuple[float, int]] = {}  # name -> (s, count)
        self.range_s: Dict[str, float] = {}  # range -> device s of its kernels
        self.busy_s = 0.0
        self.window_s = 0.0
        self.kernels = 0  # kernel launches (copies and memsets not counted)
        self.gaps: Dict[str, float] = {}  # host range during idle device time -> s

    @contextlib.contextmanager
    def record(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(STRETCH):
                yield self
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
        self._reduce(prof)

    def _reduce(self, prof) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        starts, host_ranges, dev = {}, {}, []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if name.startswith(RANGE):  # a range's own device-side span
                    continue
                dev.append((name, e.start_ns(), e.duration_ns(), e.linked_correlation_id()))
            elif e.linked_correlation_id() == 0:
                if name.startswith(RANGE):
                    host_ranges.setdefault(name, []).append(
                        (e.start_ns(), e.start_ns() + e.duration_ns()))
                else:
                    starts[e.correlation_id()] = e.start_ns()
        lo, hi = host_ranges.get(STRETCH, [(0, 0)])[0]
        self.window_s = (hi - lo) * 1e-9
        for name, _, dur, _ in dev:
            s, n = self.device_ops.get(name, (0.0, 0))
            self.device_ops[name] = (s + dur * 1e-9, n + 1)
        self.kernels = sum(1 for name, *_ in dev if not name.startswith(("Memcpy", "Memset")))
        # device time by range: kernels whose launching operator started inside
        launched = np.array([starts.get(c, -1) for *_, c in dev], dtype=np.int64)
        dur = np.array([d for _, _, d, _ in dev], dtype=np.float64) * 1e-9
        for name, iv in host_ranges.items():
            if name == STRETCH:
                continue
            iv = np.array(sorted(iv), dtype=np.int64)
            i = np.searchsorted(iv[:, 0], launched, side="right") - 1
            inside = (i >= 0) & (launched < iv[np.maximum(i, 0), 1])
            self.range_s[name] = float(dur[inside].sum())
        # the busy union inside the stretch, and its idle gaps
        spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d, _ in dev if s + d > lo and s < hi)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        edges = np.array([lo] + [x for m in merged for x in m] + [hi], dtype=np.int64)
        a, b = edges[0::2], edges[1::2]
        keep = b > a
        a, b = a[keep], b[keep]
        label = np.full(a.shape, -1)
        width = np.full(a.shape, np.iinfo(np.int64).max)
        names = [n for n in host_ranges if n != STRETCH]
        for k, name in enumerate(names):  # the innermost range open at a gap's start
            iv = np.array(sorted(host_ranges[name]), dtype=np.int64)
            i = np.searchsorted(iv[:, 0], a, side="right") - 1
            j = np.maximum(i, 0)
            w = iv[j, 1] - iv[j, 0]
            hit = (i >= 0) & (a < iv[j, 1]) & (w < width)
            label[hit], width[hit] = k, w[hit]
        for k in np.unique(label):
            name = names[k] if k >= 0 else "outside any range"
            self.gaps[name] = float((b - a)[label == k].sum()) * 1e-9

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(((n, s) for n, (s, _) in self.device_ops.items()), key=lambda x: -x[1])
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:120], s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def readers_hooks(readers: Dict[str, Any], state: Dict[str, Any]):
    """The ranges and probes the cell's per-layer readers ask for; a probe
    is built by its reader's ``PROBES[target](state)``."""
    ranges, probes = {}, {}
    for mod in readers.values():
        ranges.update(getattr(mod, "RANGES", {}))
        for spec, make in getattr(mod, "PROBES", {}).items():
            probes[spec] = make(state)
    return ranges, probes


@contextlib.contextmanager
def host_range(name: str, on: bool):
    """A ``record_function`` range on the host when ``on`` (the traced
    stretch), nothing otherwise."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
