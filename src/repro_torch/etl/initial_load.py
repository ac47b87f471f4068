"""(Port copy of ``repro.etl.initial_load``, on PyTorch: every instance's
``METLApp`` runs on ``device``, the card unless the caller passes
``device="cpu"``.)

Initial loads with horizontally-scaled METL instances (paper §5.5, §6.4).

The paper's rule: horizontal scaling is legal only while the configuration
state ``i`` is pinned — "during these slots, changes to the schemata and,
therefore, to the distributed system and the matrix, can be disabled".

:func:`initial_load` freezes the coordinator, splits the backlog into
deterministic shards (the same shard function the trainer's straggler logic
uses), maps each shard on its own METL instance, and thaws.  Because event
slices are pure in (state, position), the result is independent of the
instance count — property-tested in tests/test_etl_ops.py.
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional

from ..core.dmm_torch import DeviceLike
from ..core.state import StateCoordinator
from .events import EventSource
from .metl import CanonicalRow, METLApp

__all__ = ["initial_load"]


def initial_load(
    coordinator: StateCoordinator,
    source: EventSource,
    *,
    start: int = 0,
    count: int = 4096,
    instances: int = 4,
    chunk: int = 512,
    threads: bool = False,
    device: DeviceLike = "cuda",
) -> List[CanonicalRow]:
    """Map ``count`` backlog events through ``instances`` parallel METL apps.

    Returns canonical rows in deterministic (shard, stream) order.  With
    ``threads=True`` the instances run on a thread pool (I/O-bound JVM
    analogue); default is sequential execution with identical semantics.

    Every instance builds its own engine, host arenas and plan on
    ``device``; with ``threads=True`` several apps launch on one card from
    several threads, each on its own arenas.  The kernels' module-level
    launch counters (``launches`` in ``repro_torch.kernels``, and
    ``ops.dispatch_count``) are plain Python ints that threads can
    miscount: hold a threaded load by its rows and each app's ``stats``.
    """
    coordinator.freeze()
    try:
        apps = [METLApp(coordinator, strict_state=True, device=device)
                for _ in range(instances)]
        states = {app.state for app in apps}
        if len(states) != 1:
            raise RuntimeError(f"instances disagree on state: {states}")

        # contiguous shard ranges: shard k handles [start + k*per, ...)
        per = -(-count // instances)
        jobs = []
        for k in range(instances):
            lo = start + k * per
            n = min(per, start + count - lo)
            if n > 0:
                jobs.append((k, lo, n))

        def run(job):
            k, lo, n = job
            rows: List[CanonicalRow] = []
            pos = lo
            while pos < lo + n:
                take = min(chunk, lo + n - pos)
                rows.extend(apps[k].consume(source.slice(pos, take)))
                pos += take
            return k, rows

        if threads:
            with concurrent.futures.ThreadPoolExecutor(max_workers=instances) as ex:
                results = list(ex.map(run, jobs))
        else:
            results = [run(j) for j in jobs]
        results.sort(key=lambda kr: kr[0])
        out: List[CanonicalRow] = []
        for _, rows in results:
            out.extend(rows)
        return out
    finally:
        coordinator.thaw()
