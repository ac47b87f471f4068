"""Device densify's one-call-a-chunk route, against the JAX reference.

With ``device_densify=True`` the fused and sharded engines pack a chunk's
raw items and routing straight into one of two host arenas
(``repro_torch.etl.engines._HostArenas``, pinned on a card), and
``dispatch`` maps it with one ``ops.dmm_apply_packed`` call: on the card
one C call that copies the arena to the device and launches
``densify_map`` or ``densify_map_shard``, on the CPU a copy of the arena
through the plain version.  The outputs are one allocation, values then
mask, read back by ``emit`` with one copy.  Covered here on the CPU: the
arena's bytes against the reference's packing; forced device-densify
consume (``min_device_events=0``) against the reference, fused and sharded
over four CPU shards, at chunk sizes 3, 40 and 200 across a schema
evolution, with the reported counts (1 transfer and 1 dispatch a chunk);
rows kept from a chunk unchanged while both arenas are reused; a chunk
whose arena a later densify took; the op's refusals.  On a Hopper card
(marker ``gpu``) the warp-per-row body is held bit for bit against the
plain version on ``chip_smoke.DENSIFY_EDGE_CASES`` (K 1-64, widths that
are no multiple of 4 and 384, 1-8 shards and sub-ranges, a misaligned
table) with the C entry's reported counts, and consume on the card against
the CPU.
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
from repro.etl.engines import _pack_columnar as r_pack_columnar
from repro.etl.transport import decode_snapshot, encode_snapshot

from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import FusedEngine, METLApp, ShardedEngine
from repro_torch.etl.engines import ColumnarDense, _chunk_layout
from repro_torch.kernels import densify_map as dm_mod
from repro_torch.kernels import ops
from repro_torch.kernels.densify_map import densify_map_chunk
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


def _engine(kind, device="cpu", min_device_events=0):
    if kind == "fused":
        return FusedEngine(device=device, device_densify=True,
                           min_device_events=min_device_events)
    return ShardedEngine(mesh=make_etl_mesh(devices=[device] * N), device_densify=True,
                         min_device_events=min_device_events)


def _port_app(kind, snap=None, device="cpu"):
    snap = _snapshot() if snap is None else snap
    return METLApp(coordinator_from_snapshot(snap), engine=_engine(kind, device))


def _chunks(registry, chunk_size, n_chunks):
    src = REventSource(registry, seed=5, p_duplicate=0.1, p_stale=0.05)
    return [_port_events(src.slice(k * chunk_size, chunk_size)) for k in range(n_chunks)]


class _Dispatches:
    """Counts an engine's device-densify dispatches (an observer on its
    public ``dispatch``)."""

    def __init__(self, engine) -> None:
        self.inner, self.n = engine.dispatch, 0
        engine.dispatch = self

    def __call__(self, dense):
        self.n += isinstance(dense, ColumnarDense)
        return self.inner(dense)


# ---------------------------------------------------------------------------
# the arena densify writes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ENGINES)
def test_packed_bytes_in_the_arena_equal_the_reference(kind):
    """The bytes ``densify`` writes into the arena equal the reference's
    ``_pack_columnar`` on the same layout and routing, byte for byte, and
    (fused) the reference engine's own ``ColumnarDense.packed``."""
    snap = _snapshot()
    r_app = RMETLApp(decode_snapshot(snap), engine="fused", device_densify=True)
    t_app = _port_app(kind, snap)
    eng = t_app.engine
    events = REventSource(r_app.coordinator.registry, seed=8, p_duplicate=0.0).slice(0, 120)
    tri = t_app.triage(_port_events(events))
    dense = eng.densify(tri)
    assert isinstance(dense, ColumnarDense)
    arena = dense.host.numpy()
    assert np.shares_memory(dense.packed, arena)
    got = arena[: dense.packed.nbytes]
    # the reference's packing of the port's own layout and routing
    layout = _chunk_layout(eng.plan, tri)
    if kind == "fused":
        s = layout.row_ids.size
        rows = np.zeros(dense.n_rows, np.int32)
        blks = np.zeros(dense.n_rows, np.int32)
        rows[:s], blks[:s] = layout.row_ids, layout.blk_ids
    else:
        _, rows, blks = eng._shard_split(layout.row_ids, layout.blk_ids)
    want, ni, b, k = r_pack_columnar(layout, rows.ravel(), blks.ravel())
    assert (ni, b, k) == (dense.n_items, dense.n_events, dense.k)
    np.testing.assert_array_equal(got, want.view(np.uint8))
    if kind == "fused":
        r_dense = r_app.engine.densify(r_app.triage(events))
        np.testing.assert_array_equal(got, np.asarray(r_dense.packed).view(np.uint8))


# ---------------------------------------------------------------------------
# forced device-densify consume against the reference
# ---------------------------------------------------------------------------


def _forced_parity(kind: str, chunk_size: int) -> None:
    """``_run_stream`` (duplicates, stale and parked events, odd payloads, a
    ``SchemaEvolved``, the refresh that replays) through the reference's
    and the port's forced device-densify apps: rows bit for bit, ``stats``
    equal, and every device-densify chunk counted as 1 transfer and 1
    dispatch from what ``dmm_apply_packed`` reported.  The sharded
    reference needs four JAX devices (run in a subprocess)."""
    from repro.etl import FusedEngine as RFusedEngine
    from repro.etl import ShardedEngine as RShardedEngine
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    snap = _snapshot()
    if kind == "fused":
        r_eng = RFusedEngine(device_densify=True, min_device_events=0)
    else:
        r_eng = RShardedEngine(mesh=r_make_etl_mesh(N), device_densify=True,
                               min_device_events=0)
    r_app = RMETLApp(decode_snapshot(snap), engine=r_eng)
    t_app = _port_app(kind, snap)
    seen = _Dispatches(t_app.engine)
    n0 = ops.dispatch_count
    assert _run_stream(r_app, t_app, chunk_size) > 0
    assert dict(t_app.stats) == dict(r_app.stats)
    for key in STAT_KEYS:
        assert t_app.stats[key] == r_app.stats[key], key
    assert seen.n > 0
    assert t_app.stats["transfers"] == t_app.stats["dispatches"] == seen.n
    assert ops.dispatch_count - n0 == seen.n


@pytest.mark.parametrize("chunk_size", [3, 40, 200])
@pytest.mark.parametrize("kind", ENGINES)
def test_forced_device_densify_matches_reference(kind, chunk_size):
    if kind == "fused":
        _forced_parity(kind, chunk_size)
        return
    out = run_sub(f"""
        import sys
        sys.path.insert(0, {str(TESTS)!r})
        import test_torch_densify_launch as t
        t._forced_parity({kind!r}, {chunk_size})
        print("subprocess OK")
    """)
    assert "subprocess OK" in out


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


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ENGINES)
def test_op_reports_one_copy_one_dispatch_and_matches_the_op_level_route(kind):
    """``dmm_apply_packed`` on a densified chunk: 1 copy and 1 dispatch,
    ``dispatch_count`` up by one, values and mask views of one allocation,
    equal to the op-level ``dmm_apply_columnar*`` on the same buffer; the
    arena is left as it was."""
    t_app = _port_app(kind)
    eng = t_app.engine
    dense = eng.densify(t_app.triage(_chunks(t_app.coordinator.registry, 60, 1)[0]))
    plan, before = dense.plan, dense.host.clone()
    sizes = dict(n_items=dense.n_items, n_events=dense.n_events, n_rows=dense.n_rows,
                 k=dense.k)
    if kind == "fused":
        args, extra = (plan.uid_slot_dev, plan.uid_col_dev, plan.src2d), {}
        want = ops.dmm_apply_columnar(torch.from_numpy(dense.packed.copy()), *args, **sizes)
        shape = (1, dense.n_rows, plan.width)
        want = tuple(w[None] for w in want)
    else:
        args = (plan.uid_slot_dev, plan.uid_col_dev, plan.src3d)
        extra = dict(mesh=eng.mesh, n_shards=N)
        want = ops.dmm_apply_columnar_sharded(torch.from_numpy(dense.packed.copy()), *args,
                                              **extra, **sizes)
        shape = (N, dense.n_rows, plan.width)
    n0 = ops.dispatch_count
    out = ops.dmm_apply_packed(dense.host, *args, **extra, **sizes)
    assert (out.copies, out.dispatches) == (1, 1)
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
    CPU arena, a device without a kernel, and shards outside the routing;
    the engines' op refuses shards without a mesh."""
    tab = torch.zeros(4, dtype=torch.int32)
    table = torch.zeros((1, 8, 128), dtype=torch.int32)
    sizes = dict(n_items=8, n_events=8, n_rows=8, k=1)
    n_bytes = 4 * (2 * 8 + 3 * 8 + 2 * 8)
    host = torch.zeros(n_bytes, dtype=torch.uint8)
    for bad in (host[:-4], host.view(torch.int32), host.reshape(2, -1)):
        with pytest.raises(ValueError, match="uint8 CPU arena"):
            densify_map_chunk(bad, tab, tab, table, **sizes)
    meta = dict(uid_slot=tab.to("meta"), uid_col=tab.to("meta"), table=table.to("meta"))
    with pytest.raises(ValueError, match="no densify_map kernel for device meta"):
        densify_map_chunk(host, **meta, **sizes)
    with pytest.raises(ValueError, match="without a mesh"):
        ops.dmm_apply_packed(host, tab, tab, table[0], n_shards=2, **sizes)
    l0, s0 = dm_mod.launches, dm_mod.shard_launches
    raw, copies, launched = densify_map_chunk(host, tab, tab, table, **sizes)
    assert (copies, launched) == (1, 1) and raw.numel() == 5 * 8 * 128
    # the plain version on the CPU is no kernel launch
    assert (dm_mod.launches, dm_mod.shard_launches) == (l0, s0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_body_matches_plain_on_edge_cases(hopper):
    """The warp-per-row body (``densify_map`` and ``densify_map_shard``)
    and the C chunk entry bit for bit against the plain version over
    ``chip_smoke.DENSIFY_EDGE_CASES``, each chunk call reporting 1 copy and
    1 launch (``check_densify_edges``)."""
    n = smoke.check_densify_edges(hopper)
    torch.cuda.synchronize()
    assert n == 2 * len(smoke.DENSIFY_EDGE_CASES)


@pytest.mark.gpu
def test_unpinned_arena_raises_on_the_card(hopper):
    tab = torch.zeros(4, dtype=torch.int32, device=hopper)
    table = torch.zeros((1, 8, 128), dtype=torch.int32, device=hopper)
    host = torch.zeros(4 * 56, dtype=torch.uint8)
    with pytest.raises(ValueError, match="pinned host arena"):
        densify_map_chunk(host, tab, tab, table, n_items=8, n_events=8, n_rows=8, k=1)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ENGINES)
def test_consume_on_the_card_counts_from_the_chunk_call(hopper, kind):
    """Forced device-densify consume on the card against the CPU: rows and
    ``stats`` equal, and each device-densify chunk one launch of the
    path's kernel, as the C entry reported it."""
    snap = _snapshot()
    apps = [_port_app(kind, snap, device) for device in (hopper, "cpu")]
    counter = "launches" if kind == "fused" else "shard_launches"
    seen = _Dispatches(apps[0].engine)
    l0 = getattr(dm_mod, counter)
    for events in _chunks(apps[0].coordinator.registry, 200, 4):
        _assert_rows_equal(apps[0].consume(events), apps[1].consume(events))
    assert dict(apps[0].stats) == dict(apps[1].stats)
    assert getattr(dm_mod, counter) - l0 == seen.n == apps[0].stats["dispatches"] > 0
