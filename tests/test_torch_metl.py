"""The port's consume path against the reference ``METLApp``, on the CPU.

Both apps start from one state, carried across with
``coordinator_from_snapshot(encode_snapshot(coord))``, and consume the same
stream: synthetic chunks with duplicates and stale (dead-lettered) events,
events from the app's future (parked, then replayed), hand-made events with
unknown, out-of-range and negative uids and non-numeric payloads, and one
``SchemaEvolved`` mid-stream.  Rows (routes, keys, values bit for bit,
masks, in order) and every ``stats`` counter must be equal, for host and
device densify, at several chunk sizes.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario
from repro.core.synthetic import churn_schedule
from repro.etl import CDCEvent as RCDCEvent, EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.transport import decode_snapshot, encode_snapshot

from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import CDCEvent as TCDCEvent
from repro_torch.etl import FusedEngine, METLApp
from repro_torch.etl.control import SchemaEvolved as TSchemaEvolved
from repro_torch.kernels import ops

STAT_KEYS = ("dispatches", "transfers", "unknown_uid", "bad_payload", "replayed",
             "mapped", "empty", "duplicates", "events", "stale", "parked",
             "dead_lettered", "refreshes", "evictions")

CFG = ScenarioConfig(n_schemas=4, versions_per_schema=3, attrs_per_version=6,
                     n_entities=2, cdm_attrs=8, seed=21)


def _apps(device_densify, **port_kwargs):
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_coord, t_coord = decode_snapshot(snap), coordinator_from_snapshot(snap)
    r_app = RMETLApp(r_coord, engine="fused", device_densify=device_densify)
    t_app = METLApp(t_coord, device="cpu", device_densify=device_densify,
                    **port_kwargs)
    return r_app, t_app


def _port_events(events):
    return [TCDCEvent(**dataclasses.asdict(ev)) for ev in events]


def _odd_events(registry, rng, base_key):
    """Events the synthetic source never makes: unknown, out-of-range and
    negative uids, a uid of another column, and non-numeric values."""
    blocks = registry.domain.blocks()
    state = registry.state
    out = []
    for i in range(6):
        sv = blocks[int(rng.integers(len(blocks)))]
        payload = {u: float(rng.integers(1, 1000)) for u in sv.uids}
        kind = i % 6
        if kind == 0:
            payload[10**7] = 1.0
        elif kind == 1:
            payload[2**40] = 2.0
        elif kind == 2:
            payload[-3] = 3.0
        elif kind == 3:
            payload[sv.uids[0]] = "bad"
        elif kind == 4:
            other = blocks[(blocks.index(sv) + 1) % len(blocks)]
            payload[other.uids[-1]] = 4.0
        else:
            payload[sv.uids[-1]] = True  # a bool is a schema error too
        out.append(RCDCEvent(key=base_key + i, op="c", state=state,
                             schema_id=sv.schema_id, version=sv.version,
                             before=None, after=payload, ts=base_key + i))
    return out


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x[0] == y[0] and x[3] == y[3]
        assert x[1].dtype == y[1].dtype and x[2].dtype == y[2].dtype
        np.testing.assert_array_equal(x[1].view(np.int32), np.asarray(y[1]).view(np.int32))
        np.testing.assert_array_equal(x[2], y[2])


def _run_stream(r_app, t_app, chunk_size, n_chunks=6, evolve_at=3,
                assert_rows=_assert_rows_equal):
    r_coord, t_coord = r_app.coordinator, t_app.coordinator
    src = REventSource(r_coord.registry, seed=5, p_duplicate=0.1, p_stale=0.05)
    evolution = churn_schedule(r_coord.registry, steps=1, first_chunk=evolve_at, seed=2)
    rng = np.random.default_rng(chunk_size)
    parked = []
    n_rows = 0
    for k in range(n_chunks):
        if k in evolution:
            ev = evolution[k]
            r_coord.apply(ev)
            t_coord.apply(TSchemaEvolved(tree=ev.tree, schema_id=ev.schema_id,
                                         keep=ev.keep, add=ev.add))
        events = list(src.slice(k * chunk_size, chunk_size))
        if k == 1:  # from the app's future: parked now, replayed after the bump
            ahead = r_coord.registry.state + 1
            parked = [dataclasses.replace(e, key=10**6 + j, state=ahead)
                      for j, e in enumerate(events[:3])]
            events += parked
        if k in (2, evolve_at + 1):
            events += _odd_events(r_coord.registry, rng, 10**7 + 100 * k)
        r_rows = r_app.consume(events)
        t_rows = t_app.consume(_port_events(events))
        assert_rows(t_rows, r_rows)
        n_rows += len(r_rows)
    return n_rows


@pytest.mark.parametrize("device_densify", [False, True])
@pytest.mark.parametrize("chunk_size", [3, 40, 200])
def test_consume_matches_reference(chunk_size, device_densify):
    r_app, t_app = _apps(device_densify)
    n_rows = _run_stream(r_app, t_app, chunk_size)
    assert n_rows > 0
    for key in STAT_KEYS:
        assert t_app.stats[key] == r_app.stats[key], key
    assert dict(t_app.stats) == dict(r_app.stats)
    # the stream reaches every accounting path it is meant to
    for key in ("duplicates", "stale", "parked", "replayed", "bad_payload",
                "unknown_uid", "dead_lettered"):
        assert r_app.stats[key] > 0, key


def test_device_densify_forced_matches_reference_at_every_chunk_size():
    """With ``min_device_events=0`` every chunk takes the packed path, even
    the 3-event ones, and still equals the reference's forced device app."""
    from repro.etl import FusedEngine as RFusedEngine

    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app = RMETLApp(decode_snapshot(snap),
                     engine=RFusedEngine(device_densify=True, min_device_events=0))
    t_app = METLApp(coordinator_from_snapshot(snap), engine=FusedEngine(
        device="cpu", device_densify=True, min_device_events=0))
    _run_stream(r_app, t_app, 3)
    assert dict(t_app.stats) == dict(r_app.stats)
    assert t_app.stats["transfers"] == t_app.stats["dispatches"]


@pytest.mark.parametrize("device_densify,transfers", [(False, 4), (True, 1)])
def test_one_dispatch_per_chunk(device_densify, transfers):
    r_app, t_app = _apps(device_densify)
    chunk = REventSource(r_app.coordinator.registry, seed=6, p_duplicate=0.0).slice(0, 64)
    d0, x0, n0 = t_app.stats["dispatches"], t_app.stats["transfers"], ops.dispatch_count
    t_app.consume(_port_events(chunk))
    assert t_app.stats["dispatches"] - d0 == 1
    assert t_app.stats["transfers"] - x0 == transfers
    assert ops.dispatch_count - n0 == 1
    info = t_app.engine.info()
    assert info["device"] == "cpu" and info["device_densify"] is device_densify
    assert info["table_bytes"] == info["bytes_resident"] > 0
    assert info["role"] == "leader" and info["plan_epoch"] == 1


def test_small_chunk_takes_host_densify():
    r_app, t_app = _apps(True)
    chunk = REventSource(r_app.coordinator.registry, seed=7, p_duplicate=0.0).slice(0, 5)
    x0 = t_app.stats["transfers"]
    _assert_rows_equal(t_app.consume(_port_events(chunk)), r_app.consume(chunk))
    assert t_app.stats["transfers"] - x0 == 4


def test_reset_offset_and_dedup_match_reference():
    r_app, t_app = _apps(False)
    events = REventSource(r_app.coordinator.registry, seed=8, p_stale=0.3).slice(0, 40)
    r_app.consume(events)
    t_app.consume(_port_events(events))
    assert t_app.reset_offset() == r_app.reset_offset() is not None
    # the dead-lettered events were forgotten by dedup: they map again
    _assert_rows_equal(t_app.consume(_port_events(events)), r_app.consume(events))
    r_app.reset_dedup()
    t_app.reset_dedup()
    _assert_rows_equal(t_app.consume(_port_events(events)), r_app.consume(events))
    assert dict(t_app.stats) == dict(r_app.stats)


def test_engine_instance_keeps_its_device():
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    app = METLApp(coordinator_from_snapshot(snap), engine=FusedEngine(device="cpu"))
    assert app.device == torch.device("cpu")
    with pytest.raises(ValueError, match="conflicts"):
        METLApp(coordinator_from_snapshot(snap), engine=FusedEngine(device="cpu"),
                device="meta")
    with pytest.raises(ValueError, match="unknown engine"):
        METLApp(coordinator_from_snapshot(snap), engine="nope", device="cpu")
    # engine="sharded" without a mesh is the fused engine, as in the reference
    fallback = METLApp(coordinator_from_snapshot(snap), engine="sharded", device="cpu")
    assert isinstance(fallback.engine, FusedEngine)
    assert isinstance(app.stats, collections.Counter)


@pytest.fixture
def hopper():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("device_densify", [False, True])
def test_consume_on_the_card_matches_reference(hopper, device_densify):
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app = RMETLApp(decode_snapshot(snap), engine="fused",
                     device_densify=device_densify)
    t_app = METLApp(coordinator_from_snapshot(snap), device=hopper,
                    device_densify=device_densify)
    _run_stream(r_app, t_app, 200)
    assert dict(t_app.stats) == dict(r_app.stats)
