"""Host densify's one-call-a-chunk route, against the JAX reference.

With host densify (the default, and a device-densify app's chunks under
``min_device_events``) the fused and sharded engines scatter a chunk's
payload and write its padded routing straight into one of two host arenas
(``repro_torch.etl.engines._HostArenas``, pinned on a card), four regions
16-byte aligned (``kernels/segmented_gather.arena_layout``), and
``dispatch`` maps it with one ``ops.dmm_apply_dense`` call: on the card one
C call that copies the four operands to the device and launches
``segmented_gather`` or ``segmented_gather_shard``, on the CPU a copy of the
arena through the plain version.  The outputs are one allocation, values
then mask, read back by ``emit`` with one copy.  Covered here on the CPU:
the arena's layout; its payload and routing against the reference's
``DenseChunk`` and padded routing; host-densify consume against the
reference, fused and sharded over four CPU shards, at chunk sizes 3, 40 and
200 across a schema evolution, with the reported counts (4 transfers and 1
dispatch a chunk); rows kept from a chunk unchanged while both arenas are
reused; a chunk whose arena a later densify took; a device-densify app's
small chunks on this route; the op against the op-level ``dmm_apply_fused``
/ ``dmm_apply_sharded``; the op's refusals.  On a Hopper card (marker
``gpu``) the warp-per-row body is held bit for bit against the plain
version on ``chip_smoke.GATHER_EDGE_CASES`` with the C entry's reported
counts, an unpinned arena raises, and consume on the card counts from the
chunk call.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import build_scenario
from repro.etl import EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.transport import decode_snapshot, encode_snapshot

from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import FusedEngine, METLApp, ShardedEngine
from repro_torch.etl.engines import DenseChunk
from repro_torch.kernels import ops
from repro_torch.kernels import segmented_gather as sg_mod
from repro_torch.kernels.segmented_gather import (arena_layout, arena_views,
                                                  segmented_gather_chunk)
from repro_torch.launch.mesh import make_etl_mesh

from _subproc import run_sub as _run_sub
from test_torch_metl import (  # noqa: F401  (hopper: the card fixture)
    CFG, STAT_KEYS, _assert_rows_equal, _port_events, _run_stream, hopper,
)

TESTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("chip_smoke", TESTS.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

N = 4  # shards of the sharded cases, all on one device
ENGINES = ("fused", "sharded")
run_sub = functools.partial(_run_sub, devices=N)


def _snapshot():
    sc = build_scenario(CFG)
    return encode_snapshot(RCoordinator(sc.registry, sc.dpm))


def _engine(kind, device="cpu", device_densify=False):
    if kind == "fused":
        return FusedEngine(device=device, device_densify=device_densify)
    return ShardedEngine(mesh=make_etl_mesh(devices=[device] * N),
                         device_densify=device_densify)


def _port_app(kind, snap=None, device="cpu", device_densify=False):
    snap = _snapshot() if snap is None else snap
    return METLApp(coordinator_from_snapshot(snap),
                   engine=_engine(kind, device, device_densify))


def _ref_app(kind, snap, device_densify=False):
    """The reference app of ``kind``; the sharded one needs four JAX
    devices (a subprocess)."""
    if kind == "fused":
        return RMETLApp(decode_snapshot(snap), engine="fused", device_densify=device_densify)
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    return RMETLApp(decode_snapshot(snap), engine="sharded", mesh=r_make_etl_mesh(N),
                    device_densify=device_densify)


def _in_subprocess(call: str) -> None:
    """Run ``call`` (an expression over this module, imported as ``t``) in a
    process that sees four JAX CPU devices."""
    out = run_sub(f"""
        import sys
        sys.path.insert(0, {str(TESTS)!r})
        import test_torch_gather_launch as t
        {call}
        print("subprocess OK")
    """)
    assert "subprocess OK" in out


def _chunks(registry, chunk_size, n_chunks):
    src = REventSource(registry, seed=5, p_duplicate=0.1, p_stale=0.05)
    return [_port_events(src.slice(k * chunk_size, chunk_size)) for k in range(n_chunks)]


class _Dispatches:
    """Counts an engine's host-densify dispatches (an observer on its
    public ``dispatch``)."""

    def __init__(self, engine) -> None:
        self.inner, self.n = engine.dispatch, 0
        engine.dispatch = self

    def __call__(self, dense):
        self.n += isinstance(dense, DenseChunk)
        return self.inner(dense)


# ---------------------------------------------------------------------------
# the arena densify writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n_in,n_route,n_rows", [(8, 128, 1, 8), (13, 3, 4, 5),
                                                   (1, 1, 1, 1), (512, 128, 4, 256)])
def test_arena_layout_is_aligned_and_the_views_lie_in_it(b, n_in, n_route, n_rows):
    """The four regions start 16-byte aligned, in order, without overlap,
    inside the bytes the layout reports; the numpy and torch views of one
    arena are the same bytes."""
    at, n_bytes = arena_layout(b, n_in, n_route, n_rows)
    sizes = (4 * b * n_in, b * n_in, 4 * n_route * n_rows, 4 * n_route * n_rows)
    assert at[0] == 0 and all(a % 16 == 0 for a in at)
    for a, n, nxt in zip(at, sizes, (*at[1:], n_bytes)):
        assert a + n <= nxt
    assert n_bytes % 16 == 0 and n_bytes - at[3] - sizes[3] < 16
    arena = torch.zeros(n_bytes + 16, dtype=torch.uint8)
    t_views = arena_views(arena, b, n_in, n_route, n_rows)
    n_views = arena_views(arena.numpy(), b, n_in, n_route, n_rows)
    shapes = [(b, n_in), (b, n_in), (n_route, n_rows), (n_route, n_rows)]
    for i, (tv, nv, shape) in enumerate(zip(t_views, n_views, shapes)):
        assert tuple(tv.shape) == nv.shape == shape
        assert tv.data_ptr() - arena.data_ptr() == at[i]
        nv[...] = i + 1
        assert bool((tv == i + 1).all())
    assert t_views[0].dtype == torch.float32 and n_views[1].dtype == np.int8


def _arena_parity(kind: str) -> None:
    """The payload and routing ``densify`` writes into the arena equal the
    reference engine's ``DenseChunk`` and the routing its dispatch sends:
    ``np.pad`` of the global routing (fused) or its per-shard split."""
    snap = _snapshot()
    r_app, t_app = _ref_app(kind, snap), _port_app(kind, snap)
    events = REventSource(r_app.coordinator.registry, seed=8, p_duplicate=0.0).slice(0, 120)
    dense = t_app.engine.densify(t_app.triage(_port_events(events)))
    r_dense = r_app.engine.densify(r_app.triage(events))
    assert isinstance(dense, DenseChunk) and dense.host is not None
    arena = dense.host.numpy()
    for view in (dense.vals, dense.mask, dense.rows, dense.blks):
        assert np.shares_memory(view, arena)
    np.testing.assert_array_equal(dense.vals.view(np.int32), r_dense.vals.view(np.int32))
    np.testing.assert_array_equal(dense.mask, r_dense.mask)
    if kind == "fused":
        s = r_dense.row_ids.size
        pad = dense.rows.shape[1] - s
        assert dense.rows.shape[0] == 1 and pad >= 0
        want = [np.pad(r_dense.row_ids, (0, pad))[None], np.pad(r_dense.blk_ids, (0, pad))[None]]
    else:
        want = [r_dense.rows_sh, r_dense.blks_sh]
        for got, r_sel in zip(dense.shard_sel, r_dense.shard_sel):
            np.testing.assert_array_equal(got, r_sel)
    for got, w in zip((dense.rows, dense.blks), want):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, w)
    for key in ("row_ids", "blk_ids", "out_keys"):
        np.testing.assert_array_equal(getattr(dense, key), getattr(r_dense, key))


@pytest.mark.parametrize("kind", ENGINES)
def test_arena_payload_and_routing_equal_the_reference(kind):
    if kind == "fused":
        _arena_parity(kind)
    else:
        _in_subprocess(f"t._arena_parity({kind!r})")


# ---------------------------------------------------------------------------
# host-densify consume against the reference
# ---------------------------------------------------------------------------


def _consume_parity(kind: str, chunk_size: int) -> None:
    """``_run_stream`` (duplicates, stale and parked events, odd payloads, a
    ``SchemaEvolved``, the refresh that replays) through the reference's and
    the port's host-densify apps: rows bit for bit, ``stats`` equal, and
    every chunk counted as 4 transfers and 1 dispatch from what
    ``dmm_apply_dense`` reported."""
    snap = _snapshot()
    r_app, t_app = _ref_app(kind, snap), _port_app(kind, snap)
    seen = _Dispatches(t_app.engine)
    n0 = ops.dispatch_count
    assert _run_stream(r_app, t_app, chunk_size) > 0
    assert dict(t_app.stats) == dict(r_app.stats)
    for key in STAT_KEYS:
        assert t_app.stats[key] == r_app.stats[key], key
    assert seen.n > 0
    assert t_app.stats["transfers"] == 4 * seen.n
    assert t_app.stats["dispatches"] == seen.n == ops.dispatch_count - n0


@pytest.mark.parametrize("chunk_size", [3, 40, 200])
@pytest.mark.parametrize("kind", ENGINES)
def test_host_densify_consume_matches_reference(kind, chunk_size):
    if kind == "fused":
        _consume_parity(kind, chunk_size)
    else:
        _in_subprocess(f"t._consume_parity({kind!r}, {chunk_size})")


# ---------------------------------------------------------------------------
# the arenas across chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ENGINES)
def test_rows_survive_arena_reuse(kind):
    """Rows emitted from chunk k own their memory: consuming chunks k+1 and
    k+2 (both host arenas reused) leaves them as they were."""
    t_app = _port_app(kind)
    chunks = _chunks(t_app.coordinator.registry, 60, 3)
    first = t_app.consume(chunks[0])
    assert first
    kept = [(r[0], r[1].copy(), r[2].copy(), r[3]) for r in first]
    arenas = t_app.engine._arenas
    for events in chunks[1:]:
        assert t_app.consume(events)
    assert arenas.turns == [2, 1]
    _assert_rows_equal(first, kept)
    for buf in arenas.bufs:
        assert not any(np.shares_memory(r[1], buf.numpy()) for r in first)


@pytest.mark.parametrize("kind", ENGINES)
def test_arena_taken_again_before_dispatch_raises(kind):
    t_app = _port_app(kind)
    eng = t_app.engine
    chunks = _chunks(t_app.coordinator.registry, 60, 3)
    dense = [eng.densify(t_app.triage(events)) for events in chunks]
    assert [d.slot for d in dense] == [0, 1, 0]
    with pytest.raises(RuntimeError, match="taken by a later densify"):
        eng.dispatch(dense[0])
    for d in dense[1:]:  # the later two are still whole
        assert eng.emit(eng.dispatch(d))


@pytest.mark.parametrize("kind", ENGINES)
def test_small_chunks_of_a_device_densify_app_take_the_arena_route(kind):
    """A device-densify app maps a chunk under ``min_device_events`` (32)
    selected events by host densify through the same arenas: 4 transfers
    and 1 dispatch, rows equal to the reference fused app's, and the next
    large chunk packs into the other arena."""
    snap = _snapshot()
    r_app = _ref_app("fused", snap, device_densify=True)
    t_app = _port_app(kind, snap, device_densify=True)
    eng = t_app.engine
    src = REventSource(r_app.coordinator.registry, seed=6, p_duplicate=0.0)
    small, large = src.slice(0, 10), src.slice(10, 200)
    dense = eng.densify(t_app.triage(_port_events(small)))
    assert isinstance(dense, DenseChunk) and dense.slot == 0
    t_app.reset_dedup()
    seen = _Dispatches(eng)
    _assert_rows_equal(t_app.consume(_port_events(small)), r_app.consume(small))
    assert seen.n == 1
    assert (t_app.stats["transfers"], t_app.stats["dispatches"]) == (4, 1)
    _assert_rows_equal(t_app.consume(_port_events(large)), r_app.consume(large))
    assert (t_app.stats["transfers"], t_app.stats["dispatches"]) == (5, 2)
    assert seen.n == 1 and eng._arenas.turns == [2, 1]


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ENGINES)
def test_op_reports_four_copies_one_dispatch_and_matches_the_op_level_route(kind):
    """``dmm_apply_dense`` on a densified chunk: 4 copies and 1 dispatch,
    ``dispatch_count`` up by one, values and mask views of one allocation,
    equal to the op-level ``dmm_apply_fused`` / ``dmm_apply_sharded`` on the
    same arrays; the arena is left as it was."""
    t_app = _port_app(kind)
    eng = t_app.engine
    dense = eng.densify(t_app.triage(_chunks(t_app.coordinator.registry, 60, 1)[0]))
    plan, before = dense.plan, dense.host.clone()
    operands = [torch.from_numpy(a.copy()) for a in (dense.vals, dense.mask)]
    if kind == "fused":
        table, extra = plan.src2d, {}
        want = ops.dmm_apply_fused(*operands, torch.from_numpy(dense.rows[0].copy()),
                                   torch.from_numpy(dense.blks[0].copy()), table)
        want = tuple(w[None] for w in want)
        shape = (1, dense.rows.shape[1], plan.width)
    else:
        table, extra = plan.src3d, dict(mesh=eng.mesh, n_shards=N)
        want = ops.dmm_apply_sharded(*operands, torch.from_numpy(dense.rows.copy()),
                                     torch.from_numpy(dense.blks.copy()), table, mesh=eng.mesh)
        shape = (N, dense.rows.shape[1], plan.width)
    n0 = ops.dispatch_count
    out = ops.dmm_apply_dense(dense.host, table, **extra, **dense.sizes())
    assert (out.copies, out.dispatches) == (4, 1)
    assert ops.dispatch_count - n0 == 1
    assert out.values.shape == out.mask.shape == shape
    assert out.buf.dtype == torch.uint8 and out.buf.numel() == 5 * int(np.prod(shape))
    for view in (out.values, out.mask):
        assert view.untyped_storage().data_ptr() == out.buf.untyped_storage().data_ptr()
    np.testing.assert_array_equal(out.values.view(torch.int32).numpy(),
                                  want[0].view(torch.int32).numpy())
    np.testing.assert_array_equal(out.mask.numpy(), want[1].numpy())
    assert torch.equal(dense.host, before)


def test_op_refusals():
    """The chunk op refuses a host buffer that is not a large enough uint8
    CPU arena, a table of the wrong rank, a table stack whose shard count
    is not the routing's, and a device without a kernel; the engines' op
    refuses shards without a mesh or another count than the mesh's.  On the
    CPU the plain version runs and no launch is counted."""
    table = torch.zeros((1, 8, 128), dtype=torch.int32)
    sizes = dict(n_events=8, n_in=16, n_rows=8)
    _, n_bytes = arena_layout(8, 16, 1, 8)
    host = torch.zeros(n_bytes, dtype=torch.uint8)
    for bad in (host[:-4], host.view(torch.int32), host.reshape(2, -1)):
        with pytest.raises(ValueError, match="uint8 CPU arena"):
            segmented_gather_chunk(bad, table, **sizes)
    with pytest.raises(ValueError, match="dims, expected 2 or 3"):
        segmented_gather_chunk(host, table[0, 0], **sizes)
    with pytest.raises(ValueError, match="routed over 2 shards"):
        segmented_gather_chunk(torch.zeros(2 * n_bytes, dtype=torch.uint8), table,
                               n_route=2, **sizes)
    with pytest.raises(ValueError, match="no segmented_gather kernel for device meta"):
        segmented_gather_chunk(host, table.to("meta"), **sizes)
    with pytest.raises(ValueError, match="without a mesh"):
        ops.dmm_apply_dense(host, table[0], n_shards=2, **sizes)
    with pytest.raises(ValueError, match="the mesh's 4 shards"):
        ops.dmm_apply_dense(host, table, mesh=make_etl_mesh(devices=["cpu"] * N),
                            n_shards=2, **sizes)
    l0, s0 = sg_mod.launches, sg_mod.shard_launches
    raw, copies, launched = segmented_gather_chunk(host, table, fill=0.25, **sizes)
    assert (copies, launched) == (4, 1) and raw.numel() == 5 * 8 * 128
    values = raw[: 4 * 8 * 128].view(torch.float32)
    assert bool((values == 0.25).all()) and int(raw[4 * 8 * 128:].sum()) == 0
    # the plain version on the CPU is no kernel launch
    assert (sg_mod.launches, sg_mod.shard_launches) == (l0, s0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_body_matches_plain_on_edge_cases(hopper):
    """The warp-per-row body (``segmented_gather`` and
    ``segmented_gather_shard``) and the C chunk entry bit for bit against
    the plain version over ``chip_smoke.GATHER_EDGE_CASES``, each chunk
    call reporting 4 copies and 1 launch (``check_gather_edges``)."""
    n = smoke.check_gather_edges(hopper)
    torch.cuda.synchronize()
    assert n == 2 * len(smoke.GATHER_EDGE_CASES)


@pytest.mark.gpu
def test_unpinned_arena_raises_on_the_card(hopper):
    table = torch.zeros((1, 8, 128), dtype=torch.int32, device=hopper)
    _, n_bytes = arena_layout(8, 16, 1, 8)
    host = torch.zeros(n_bytes, dtype=torch.uint8)
    with pytest.raises(ValueError, match="pinned host arena"):
        segmented_gather_chunk(host, table, n_events=8, n_in=16, n_rows=8)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ENGINES)
def test_consume_on_the_card_counts_from_the_chunk_call(hopper, kind):
    """Host-densify consume on the card against the CPU: rows and ``stats``
    equal, and each chunk one launch of the path's kernel and 4 transfers,
    as the C entry reported them."""
    snap = _snapshot()
    apps = [_port_app(kind, snap, device) for device in (hopper, "cpu")]
    counter = "launches" if kind == "fused" else "shard_launches"
    seen = _Dispatches(apps[0].engine)
    l0 = getattr(sg_mod, counter)
    for events in _chunks(apps[0].coordinator.registry, 200, 4):
        _assert_rows_equal(apps[0].consume(events), apps[1].consume(events))
    assert dict(apps[0].stats) == dict(apps[1].stats)
    assert getattr(sg_mod, counter) - l0 == seen.n == apps[0].stats["dispatches"] > 0
    assert apps[0].stats["transfers"] == 4 * seen.n
