#!/usr/bin/env python3
"""Drive the PyTorch port's consume path on one NVIDIA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and the repository's ``src/repro_torch``; without
either it exits non-zero before printing any result.  Phases, in order (any
failure raises and the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` into
   ``build/`` (one ``nvcc`` per source, started together);
3. hold each kernel against its plain PyTorch version on the card, bit for
   bit: ``segmented_gather`` over a shape sweep with ``fill`` 0 and 0.25,
   ``densify_map`` over random packed chunks with duplicate slots, unknown,
   out-of-range and foreign-column uids and up to 32 items per event;
4. consume 64 chunks of 512 events of the paper-scale scenario (128 schemas
   x 10 versions x 10 attributes, 40 business entities of 25 attributes)
   through ``METLApp`` on the card, once with host densify and once with
   ``device_densify=True``, with one ``SchemaEvolved`` applied at chunk 32;
   check one dispatch per chunk, 4 (host) or 1 (device) transfers per chunk
   and that each path's kernel launched once per chunk; then compare every
   row and every stats counter with the same stream through
   ``device="cpu"`` apps (the plain versions);
5. time each kernel at the main path's shapes beside its plain version and
   a one-call PyTorch yardstick, L2-hot and cold, count the bytes each call
   must move on this data for its bound, and print the ``kernels`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
CHUNKS, CHUNK_EVENTS, EVOLVE_AT = 64, 512, 32
COLD_COPIES = 192  # operand copies rotated for a cold time: ~190 MB, past the 50 MB L2
SG_SWEEP = [  # (b, n_in, w) x (n_blocks, s), as the reference kernel tests
    (b, n_in, w, nb, s)
    for (b, n_in, w) in [(8, 64, 128), (37, 300, 256), (64, 128, 128)]
    for (nb, s) in [(8, 16), (16, 130)]
]


def _paper_config():
    from repro_torch.core.synthetic import ScenarioConfig

    # the paper's deployment: >80 microservices, >10,000 extraction
    # attributes, >1,000 CDM attributes, >=10 versions per schema
    return ScenarioConfig(
        n_schemas=128, versions_per_schema=10, attrs_per_version=10,
        n_entities=40, cdm_attrs=25, seed=11,
    )


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# -- phase 3: kernels against their plain versions ---------------------------


def check_segmented_gather(device: torch.device) -> int:
    from repro_torch.kernels.ref import segmented_gather_ref
    from repro_torch.kernels.segmented_gather import segmented_gather

    n = 0
    for b, n_in, w, n_blocks, s in SG_SWEEP:
        rng = np.random.default_rng(hash((b, n_in, w, n_blocks, s)) % 2**31)
        vals = rng.normal(size=(b, n_in)).astype(np.float32)
        mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
        src2d = np.full((n_blocks, w), -1, np.int32)
        for blk in range(n_blocks):
            k = int(0.5 * min(n_in, w))
            src2d[blk, rng.choice(w, size=k, replace=False)] = rng.choice(
                n_in, size=k, replace=False
            )
        rows = rng.integers(b, size=s).astype(np.int32)
        blks = rng.integers(n_blocks, size=s).astype(np.int32)
        args = [torch.from_numpy(a).to(device) for a in (vals, mask, rows, blks, src2d)]
        for fill in (0.0, 0.25):
            kv, km = segmented_gather(*args, fill=fill)
            rv, rm = segmented_gather_ref(*args, fill=fill)
            if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
                raise AssertionError(
                    f"segmented_gather != plain at b={b} n_in={n_in} w={w} "
                    f"n_blocks={n_blocks} s={s} fill={fill}"
                )
            n += 1
    return n


def _random_packed(rng, *, n_events, k_max, k, n_uid, n_cols, n_rows, n_blocks):
    """A packed device-densify chunk with every drop case: duplicate slots in
    one event, unknown uids (table holes), out-of-range and negative uids,
    uids of another column, and CSR padding."""
    uid_slot = rng.integers(0, 40, size=n_uid).astype(np.int32)
    uid_col = rng.integers(0, n_cols, size=n_uid).astype(np.int32)
    holes = rng.random(n_uid) < 0.1
    uid_slot[holes] = -1
    uid_col[holes] = -1
    counts = rng.integers(0, k_max + 1, size=n_events).astype(np.int32)
    uids, vals, starts = [], [], []
    for e in range(n_events):
        starts.append(len(uids))
        for j in range(counts[e]):
            r = rng.random()
            if r < 0.1 or n_uid == 0:
                u = int(rng.choice([-3, n_uid, n_uid + 7, 2**31 - 1]))
            elif r < 0.25 and j > 0:
                u = uids[-1]  # duplicate slot: the last writer must win
            else:
                u = int(rng.integers(0, n_uid))
            uids.append(u)
            vals.append(np.float32(rng.normal()))
    ev_col = rng.integers(0, n_cols, size=n_events).astype(np.int32)
    ni = max(8, len(uids))
    items_u = np.full(ni, -1, np.int32)
    items_u[: len(uids)] = uids
    items_v = np.zeros(ni, np.float32)
    items_v[: len(vals)] = vals
    src2d = rng.integers(-1, 40, size=(n_blocks, 128)).astype(np.int32)
    rows = rng.integers(0, n_events, size=n_rows).astype(np.int32)
    blks = rng.integers(0, n_blocks, size=n_rows).astype(np.int32)
    packed = np.concatenate([
        items_u, items_v.view(np.int32), np.asarray(starts, np.int32), counts,
        ev_col, rows, blks,
    ]).astype(np.int32)
    return packed, uid_slot, uid_col, src2d, dict(
        n_items=ni, n_events=n_events, n_rows=n_rows, k=k
    )


def check_densify_map(device: torch.device) -> int:
    from repro_torch.kernels.densify_map import densify_map
    from repro_torch.kernels.ref import densify_map_packed_ref

    n = 0
    # (events, most items in an event, K, uid-table size, output rows); K
    # below the most items checks that items past K are ignored
    for seed, (n_events, k_max, k, n_uid, n_rows) in enumerate(
        [(24, 7, 8, 60, 50), (64, 32, 32, 200, 512), (130, 16, 16, 1, 260),
         (9, 32, 32, 0, 16), (200, 3, 4, 500, 1000), (50, 20, 8, 100, 64)]
    ):
        rng = np.random.default_rng(1000 + seed)
        packed, slot, col, src2d, sizes = _random_packed(
            rng, n_events=n_events, k_max=k_max, k=k, n_uid=n_uid, n_cols=5,
            n_rows=n_rows, n_blocks=16,
        )
        args = [torch.from_numpy(a).to(device) for a in (packed, slot, col, src2d)]
        for fill in (0.0, 0.25):
            kv, km = densify_map(*args, fill=fill, **sizes)
            rv, rm = densify_map_packed_ref(*args, fill=fill, **sizes)
            if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
                raise AssertionError(f"densify_map != plain at case {seed} fill={fill}")
            n += 1
    # last writer wins: one event, K items all on slot 3, values 0..K-1
    k = 32
    packed = np.concatenate([
        np.zeros(k, np.int32), np.arange(k, dtype=np.float32).view(np.int32),
        np.int32([0]), np.int32([k]), np.int32([0]), np.int32([0]), np.int32([0]),
    ]).astype(np.int32)
    src2d = np.full((8, 128), -1, np.int32)
    src2d[0, 5] = 3
    args = [torch.from_numpy(a).to(device) for a in (
        packed, np.int32([3]), np.int32([0]), src2d)]
    kv, km = densify_map(*args, n_items=k, n_events=1, n_rows=1, k=k)
    if float(kv[0, 5]) != float(k - 1) or int(km[0, 5]) != 1 or int(km.sum()) != 1:
        raise AssertionError("densify_map: the last writer did not win")
    return n + 1


# -- phase 4: the main path ----------------------------------------------------


class Stream:
    """The scenario's CDC stream as columnar chunks, generated once and
    shared by every run (chunks are pure in registry state and position, so
    each run's coordinator would generate the same ones)."""

    def __init__(self, chunk_events: int) -> None:
        self.chunk_events = chunk_events
        self.chunks = {}

    def get(self, k: int, registry):
        from repro_torch.etl.events import EventSource

        if k not in self.chunks:
            src = EventSource(registry, seed=1)
            self.chunks[k] = src.slice_columnar(k * self.chunk_events, self.chunk_events)
        return self.chunks[k]


def run_main_path(device, device_densify, cfg, stream, *, n_chunks, evolve_at):
    """One METLApp over the stream on ``device``; returns (rows, stats,
    consume seconds per chunk, kernel launch counts, per-chunk accounting,
    the app)."""
    from repro_torch.core.state import StateCoordinator
    from repro_torch.core.synthetic import build_scenario, churn_schedule
    from repro_torch.etl.metl import METLApp
    from repro_torch.kernels import densify_map as dm, ops, segmented_gather as sg

    sc = build_scenario(cfg)
    coord = StateCoordinator(sc.registry, sc.dpm)
    sched = churn_schedule(coord.registry, steps=1, first_chunk=evolve_at, seed=0)
    app = METLApp(coord, engine="fused", device=device, device_densify=device_densify)
    rows, per_chunk, chunk_s = [], [], []
    ops.dispatch_count = 0
    sg.launches = 0
    dm.launches = 0
    for k in range(n_chunks):
        if k in sched:
            coord.apply(sched[k])
        chunk = stream.get(k, coord.registry)  # set-up, outside the clock
        before = (app.stats["dispatches"], app.stats["transfers"], sg.launches, dm.launches)
        t0 = time.perf_counter()
        out = app.consume(chunk)
        chunk_s.append(time.perf_counter() - t0)
        after = (app.stats["dispatches"], app.stats["transfers"], sg.launches, dm.launches)
        per_chunk.append(tuple(a - b for a, b in zip(after, before)))
        rows.extend(out)
    launches = {"segmented_gather": sg.launches, "densify_map": dm.launches,
                "dispatch_count": ops.dispatch_count}
    return rows, dict(app.stats), chunk_s, launches, per_chunk, app


def check_accounting(name, per_chunk, device_densify, on_card):
    for k, (disp, xfer, n_sg, n_dm) in enumerate(per_chunk):
        want_xfer = 1 if device_densify else 4
        if disp != 1 or xfer != want_xfer:
            raise AssertionError(
                f"{name} chunk {k}: {disp} dispatches, {xfer} transfers "
                f"(want 1 and {want_xfer})"
            )
        want = (0, 1) if device_densify else (1, 0)
        if on_card and (n_sg, n_dm) != want:
            raise AssertionError(
                f"{name} chunk {k}: launches segmented_gather={n_sg} "
                f"densify_map={n_dm}, want {want}"
            )


def compare_rows(name, got, want):
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, reference {len(want)}")
    for i, (x, y) in enumerate(zip(got, want)):
        if x[0] != y[0] or x[3] != y[3]:
            raise AssertionError(f"{name} row {i}: route/key {x[0]},{x[3]} != {y[0]},{y[3]}")
        if x[1].dtype != np.float32 or not np.isfinite(x[1]).all():
            raise AssertionError(f"{name} row {i}: values not finite float32")
        if not (np.array_equal(x[1].view(np.int32), y[1].view(np.int32))
                and np.array_equal(x[2], y[2])):
            raise AssertionError(f"{name} row {i}: values/mask differ from reference")


# -- phase 5: timing -------------------------------------------------------------


def stage_breakdown(app, chunks):
    """Host seconds per consume stage (triage, densify, dispatch, emit; emit
    includes the wait for the device) over ``chunks``, re-consumed after a
    dedup reset, plus the device's busy share of that wall time from
    ``torch.profiler`` (None when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    stages = {"triage": 0.0, "densify": 0.0, "dispatch": 0.0, "emit": 0.0}
    eng = app.engine
    app.reset_dedup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        for chunk in chunks:
            t0 = time.perf_counter()
            tri = app.triage(chunk)
            t1 = time.perf_counter()
            dense = eng.densify(tri)
            t2 = time.perf_counter()
            handle = eng.dispatch(dense)
            t3 = time.perf_counter()
            eng.emit(handle)
            t4 = time.perf_counter()
            for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[name] += dt
        wall = time.perf_counter() - t_start
    # device-side entries only (kernels, copies): the host ops that issued
    # them carry the same device time again
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    busy = busy_us * 1e-6 / wall if busy_us > 0 else None
    kernels = sorted(((e.key[:60], e.self_device_time_total, e.count) for e in device),
                     key=lambda x: -x[1])[:6]
    return {"events": sum(len(c) for c in chunks), "wall_s": wall, "stages_s": stages,
            "device_busy_share": busy, "top_device_us": kernels}




def time_ms(*fns, iters=100, reps=7):
    """Median device time per call: ``iters`` calls captured in one CUDA
    graph, call i running ``fns[i % len(fns)]``, replayed ``reps`` times
    between CUDA events (launch overhead of the eager loop is not in it);
    also the same loop run eagerly."""
    calls = [fns[i % len(fns)] for i in range(iters)]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fns[0]()  # warm the allocator pool on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph_ms, eager_ms = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        graph_ms.append(a.elapsed_time(b) / iters)
        a.record()
        for fn in calls:
            fn()
        b.record()
        b.synchronize()
        eager_ms.append(a.elapsed_time(b) / iters)
    return statistics.median(graph_ms), statistics.median(eager_ms)


def hot_and_cold_ms(fn, operands):
    """``fn(*operands)`` timed two ways: L2-hot (every call on the same
    operands, which stay in the card's 50 MB L2) and cold (the calls rotate
    over ``COLD_COPIES`` copies of the operands, more than the L2 holds in
    all, so each call reads its operands from HBM).  Returns (hot graph ms,
    hot eager ms, cold graph ms) per call."""
    hot, eager = time_ms(lambda: fn(*operands))
    copies = [tuple(x.clone() for x in operands) for _ in range(COLD_COPIES)]
    cold, _ = time_ms(*[functools.partial(fn, *c) for c in copies], iters=COLD_COPIES)
    return hot, eager, cold


def segmented_gather_bytes(values, mask, rows, blks, src2d) -> int:
    """Bytes one ``segmented_gather`` call must move on this data: the
    routing, each distinct block-table row it names, 1 B of mask for each
    distinct (event row, input column) that those table rows point at and
    4 B of value where that mask is set, and the outputs.  Payload the table
    names nowhere (lane padding, attributes of other versions) is not read,
    so it is not counted.  Every routed pair counts, the bucket padding's
    included, since the kernel computes those output rows too."""
    r, b = rows.cpu().numpy(), blks.cpu().numpy()
    src, m = src2d.cpu().numpy(), mask.cpu().numpy()
    pairs = np.unique(np.stack([r, b], axis=1), axis=0)
    p = src[pairs[:, 1]]
    ev = np.broadcast_to(pairs[:, :1], p.shape)
    named = p >= 0
    cells = np.unique(ev[named].astype(np.int64) * m.shape[1] + p[named])
    hits = np.count_nonzero(m.reshape(-1)[cells])
    s, w = r.size, src.shape[1]
    return int(r.nbytes + b.nbytes + np.unique(b).size * w * 4 + cells.size + 4 * hits
               + s * w * 5)


def densify_map_bytes(packed, uid_slot, uid_col, src2d, *, n_items, n_events, n_rows,
                      k) -> int:
    """Bytes one ``densify_map`` call must move on this data: the routing;
    ``starts``/``counts``/``ev_col`` of each event the routing names; the uid
    of each item those events hold (up to ``k``); the ``uid_slot`` entry of
    each distinct in-range uid, the ``uid_col`` entry of each with a slot, the
    value of each item that resolves; each distinct block-table row named;
    and the outputs.  Bucket padding of the item and event sections that no
    routed event reaches is not read, so it is not counted."""
    pk, slot, col = (x.cpu().numpy() for x in (packed, uid_slot, uid_col))
    o = 2 * n_items
    starts, counts = pk[o : o + n_events], pk[o + n_events : o + 2 * n_events]
    ev_col = pk[o + 2 * n_events : o + 3 * n_events]
    o += 3 * n_events
    rows, blks = pk[o : o + n_rows], pk[o + n_rows : o + 2 * n_rows]
    evs = np.unique(np.clip(rows, 0, n_events - 1))
    n = np.clip(counts[evs], 0, k)
    ev = np.repeat(evs, n)
    j = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    ix = np.clip(starts[ev].astype(np.int64) + j, 0, n_items - 1)
    uid = pk[ix]
    in_range = (uid >= 0) & (uid < slot.size)
    u = uid[in_range]
    has_slot = slot[u] >= 0
    resolves = np.zeros(ix.size, bool)
    resolves[np.flatnonzero(in_range)[has_slot]] = col[u[has_slot]] == ev_col[ev[in_range][has_slot]]
    w = src2d.shape[1]
    return int(2 * n_rows * 4 + evs.size * 12 + np.unique(ix).size * 4
               + np.unique(u).size * 4 + np.unique(u[has_slot]).size * 4
               + np.unique(ix[resolves]).size * 4 + np.unique(blks).size * w * 4
               + n_rows * w * 5)


def main_path_operands(app, chunk):
    """The device operands ``app``'s engine builds for ``chunk``."""
    from repro_torch.etl.engines import ColumnarDense
    from repro_torch.core.dmm_torch import bucket_rows

    dense = app.engine.densify(app.triage(chunk))
    plan, dev = dense.plan, app.device
    if isinstance(dense, ColumnarDense):
        return dense, plan, (torch.from_numpy(dense.packed).to(dev),)
    s = dense.row_ids.size
    pad = bucket_rows(s) - s
    return dense, plan, tuple(torch.from_numpy(a).to(dev) for a in (
        dense.vals, dense.mask, np.pad(dense.row_ids, (0, pad)),
        np.pad(dense.blk_ids, (0, pad))))


def measure_segmented_gather(app, chunk):
    from repro_torch.kernels.ref import segmented_gather_ref
    from repro_torch.kernels.segmented_gather import segmented_gather

    dense, plan, (v, m, r, b) = main_path_operands(app, chunk)
    t = plan.src2d
    kv, km = segmented_gather(v, m, r, b, t)
    rv, rm = segmented_gather_ref(v, m, r, b, t)
    if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
        raise AssertionError("segmented_gather != plain at the main-path shape")
    err = float((kv - rv).abs().max())

    def yardstick(v, m, r, b, t):
        src = t[b]
        safe = src.clamp(min=0)
        hit = (m[r].gather(1, safe) != 0) & (src >= 0)
        return torch.where(hit, v[r].gather(1, safe), 0.0), hit

    yv, ym = yardstick(v, m, r, b, t)
    if not (_bits_equal(yv, rv) and torch.equal(ym.to(torch.int8), rm)):
        raise AssertionError("yardstick != plain at the main-path shape")
    ops = (v, m, r, b, t)
    ms, eager, cold = hot_and_cold_ms(segmented_gather, ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(segmented_gather_ref, ops)
    lib_ms, _, lib_cold = hot_and_cold_ms(yardstick, ops)
    return {
        "shape": {"S": int(r.numel()), "S_true": int(dense.row_ids.size),
                  "W": int(t.shape[1]), "B": int(v.shape[0]), "N_in": int(v.shape[1]),
                  "n_blocks_pad": int(t.shape[0]),
                  "blocks_touched": int(torch.unique(b).numel())},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": lib_ms, "library_cold_ms": lib_cold,
        "operand_bytes": int(sum(x.nbytes for x in ops)),
        "bytes": segmented_gather_bytes(*ops),
    }


def measure_densify_map(app, chunk):
    from repro_torch.kernels.densify_map import densify_map
    from repro_torch.kernels.ref import densify_map_packed_ref, route_offset

    dense, plan, (p,) = main_path_operands(app, chunk)
    sizes = dict(n_items=dense.n_items, n_events=dense.n_events,
                 n_rows=dense.n_rows, k=dense.k)
    tabs = (plan.uid_slot_dev, plan.uid_col_dev, plan.src2d)
    kv, km = densify_map(p, *tabs, **sizes)
    rv, rm = densify_map_packed_ref(p, *tabs, **sizes)
    if not (_bits_equal(kv, rv) and _bits_equal(km, rm)):
        raise AssertionError("densify_map != plain at the main-path shape")
    err = float((kv - rv).abs().max())
    ops = (p, *tabs)
    ms, eager, cold = hot_and_cold_ms(functools.partial(densify_map, **sizes), ops)
    plain_ms, _, plain_cold = hot_and_cold_ms(
        functools.partial(densify_map_packed_ref, **sizes), ops)
    o = route_offset(dense.n_items, dense.n_events)
    touched = np.unique(dense.packed[o + dense.n_rows : o + 2 * dense.n_rows]).size
    return {
        "shape": {"S": dense.n_rows, "S_true": int(dense.row_ids.size),
                  "W": plan.width, "NI": dense.n_items, "B": dense.n_events,
                  "K": dense.k, "packed_bytes": int(p.nbytes),
                  "blocks_touched": int(touched)},
        "max_abs_err": err, "ms": ms, "eager_ms": eager, "cold_ms": cold,
        "plain_ms": plain_ms, "plain_cold_ms": plain_cold,
        "library_ms": None, "library_cold_ms": None,
        "operand_bytes": int(sum(x.nbytes for x in ops)),
        "bytes": densify_map_bytes(*ops, **sizes),
    }


# -- main --------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {REPO}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    secs = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          + json.dumps({k: round(v, 2) for k, v in secs.items()}), flush=True)
    for name in build.KERNELS:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    n_sg = check_segmented_gather(dev)
    n_dm = check_densify_map(dev)
    torch.cuda.synchronize()
    print(f"kernels vs plain versions: segmented_gather {n_sg} cases, "
          f"densify_map {n_dm} cases, bit-exact", flush=True)

    cfg = _paper_config()
    stream = Stream(CHUNK_EVENTS)
    runs = {}
    for name, device, dd in (("cuda/host", dev, False), ("cuda/device", dev, True),
                             ("cpu/host", "cpu", False), ("cpu/device", "cpu", True)):
        rows, stats, chunk_s, launches, per_chunk, app = run_main_path(
            device, dd, cfg, stream, n_chunks=CHUNKS, evolve_at=EVOLVE_AT
        )
        if device == dev:
            torch.cuda.synchronize()
        check_accounting(name, per_chunk, dd, on_card=device == dev)
        runs[name] = (rows, stats, launches, app)
        info = app.engine.info()
        seconds, median_s = sum(chunk_s), statistics.median(chunk_s)
        print(f"main path {name}: {CHUNKS} x {CHUNK_EVENTS} events in "
              f"{seconds:.3f} s consume = {CHUNKS * CHUNK_EVENTS / seconds:.0f} ev/s "
              f"(median chunk {median_s * 1e3:.3f} ms = "
              f"{CHUNK_EVENTS / median_s:.0f} ev/s; first chunk "
              f"{chunk_s[0] * 1e3:.1f} ms, chunk {EVOLVE_AT} {chunk_s[EVOLVE_AT] * 1e3:.1f} ms); "
              f"rows {len(rows)}; dispatches {stats['dispatches']}; transfers "
              f"{stats['transfers']}; launches {json.dumps(launches)}; "
              f"n_blocks {info['n_blocks']} table_bytes {info['table_bytes']}",
              flush=True)
    for path in ("host", "device"):
        got, want = runs[f"cuda/{path}"], runs[f"cpu/{path}"]
        compare_rows(f"cuda/{path}", got[0], want[0])
        if got[1] != want[1]:
            raise AssertionError(f"cuda/{path} stats {got[1]} != cpu {want[1]}")
    compare_rows("cuda/device vs cuda/host", runs["cuda/device"][0], runs["cuda/host"][0])
    if runs["cuda/host"][2]["segmented_gather"] < 1 or runs["cuda/device"][2]["densify_map"] < 1:
        raise AssertionError("a kernel of the main path never launched")
    print("main path: rows and stats bit-exact with the cpu runs", flush=True)

    # where the consume time goes, on chunks after the evolution
    sg_app, dm_app = runs["cuda/host"][3], runs["cuda/device"][3]
    later = [stream.chunks[k] for k in range(EVOLVE_AT + 1, CHUNKS)]
    for name, app in (("cuda/host", sg_app), ("cuda/device", dm_app)):
        print(f"stages {name}: " + json.dumps(stage_breakdown(app, later)), flush=True)

    # timing at the main path's shapes, on a chunk after the evolution
    probe = stream.chunks[EVOLVE_AT + 1]
    sg_app.reset_dedup()
    dm_app.reset_dedup()
    meas = {"segmented_gather": measure_segmented_gather(sg_app, probe),
            "densify_map": measure_densify_map(dm_app, probe)}
    torch.cuda.synchronize()
    origin = {
        "segmented_gather": ("src/repro_torch/kernels/csrc/segmented_gather.cu",
                             "src/repro/kernels/segmented_gather.py:91",
                             runs["cuda/host"][2]["segmented_gather"]),
        "densify_map": ("src/repro_torch/kernels/csrc/densify_map.cu",
                        "src/repro/kernels/densify_map.py:95",
                        runs["cuda/device"][2]["densify_map"]),
    }
    kernels = []
    for name, m in meas.items():
        source, replaces, launches = origin[name]
        bound_ms = m["bytes"] / PEAK_BYTES_PER_S * 1e3
        print(f"timing {name}: " + json.dumps({**m, "bound_ms": bound_ms}), flush=True)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": m["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
