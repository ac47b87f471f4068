"""The port's multi-instance ``Cluster`` and ``initial_load`` against the
reference's, on the CPU.

Counterparts of ``tests/test_cluster.py`` and of ``tests/test_etl_ops.py``'s
initial-load cases.  Both sides start from one state
(``coordinator_from_snapshot(encode_snapshot(coord))``) and slice the same
synthetic stream (the sources are copies); the port runs every instance on
``device="cpu"``.  Rows (routes, keys, values bit for bit, masks, in order),
``ClusterStats`` and the summed ``stats`` must be equal; the cluster's
merged rows must also equal one port instance over the unsliced stream.
"""

import dataclasses

import numpy as np
import pytest

import repro.etl as R
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario
from repro.etl.initial_load import initial_load as r_initial_load
from repro.etl.transport import decode_snapshot, encode_snapshot

import repro_torch.etl as T
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl.initial_load import initial_load
from repro_torch.launch.mesh import make_etl_mesh

from test_torch_metl import _assert_rows_equal

SIDES = {"ref": R, "port": T}
# the reference's Cluster builds its apps with impl="ref", its name for the
# per-block gather the port calls "gather"
MODES = {"host": {}, "device": {"device_densify": True}, "blocks": {"engine": "blocks"}}


def _world(seed):
    sc = build_scenario(ScenarioConfig(seed=seed))
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    return {"ref": decode_snapshot(snap), "port": coordinator_from_snapshot(snap)}


def _kw(side, **kwargs):
    return {**kwargs, "device": "cpu"} if side == "port" else kwargs


def _evolve(E, reg, which=0, tag="evo"):
    o = reg.domain.schema_ids()[which]
    v = reg.domain.latest_version(o)
    keep = tuple(a.name for a in reg.domain.get(o, v).attributes)[1:]
    return E.SchemaEvolved(tree="domain", schema_id=o, keep=keep, add=(tag,))


def _single_rows(seed, n_chunks, size, boundary, mode="host", **pipe_kwargs):
    """One port instance over the unsliced stream, the evolution in band."""
    coord = _world(seed)["port"]
    app = T.METLApp(coord, device="cpu", **MODES[mode])
    sink = T.CollectSink()
    T.Pipeline(T.EventChunkSource(T.EventSource(coord.registry, seed=7), chunk_size=size,
                                  max_chunks=n_chunks,
                                  control={boundary: _evolve(T, coord.registry)}),
               app, [sink], **pipe_kwargs).run()
    return sink.rows, app


def _clusters(seed, *, sink_limit=None, stream_kwargs=None, evolve_at=None, **kwargs):
    """The same ``Cluster.over_stream`` on both sides: {side: (cluster, sink,
    coordinator)}."""
    out = {}
    for side, coord in _world(seed).items():
        E = SIDES[side]
        sink = E.CollectSink(limit=sink_limit)
        control = ({evolve_at: _evolve(E, coord.registry)} if evolve_at is not None
                   else None)
        stream = E.EventSource(coord.registry, seed=7, **(stream_kwargs or {}))
        cluster = E.Cluster.over_stream(coord, stream, sinks=[sink], control=control,
                                        **_kw(side, **kwargs))
        out[side] = (cluster, sink, coord)
    return out


def _assert_clusters_equal(out):
    (rc, rs, _), (tc, ts, _) = out["ref"], out["port"]
    _assert_rows_equal(ts.rows, rs.rows)
    for ra, ta in zip(rc.apps, tc.apps):
        assert dict(ta.stats) == dict(ra.stats)
    return ts.rows


@pytest.mark.parametrize("async_consume", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_cluster_matches_reference_and_single_instance(mode, async_consume):
    """Four instances over sliced sources == the reference's cluster == one
    port instance over the unsliced stream, row for row, across a
    mid-stream evolution applied once by the single writer."""
    n_chunks, size, boundary = 8, 64, 4
    out = _clusters(91, instances=4, chunk_size=size, max_chunks=n_chunks,
                    evolve_at=boundary, async_consume=async_consume, **MODES[mode])
    sts = {side: dataclasses.asdict(c.run()) for side, (c, _, _) in out.items()}
    assert sts["port"] == sts["ref"]
    assert sts["port"]["chunks"] == n_chunks and sts["port"]["control"] == 1
    rows = _assert_clusters_equal(out)
    single, app = _single_rows(91, n_chunks, size, boundary, mode,
                               async_consume=async_consume)
    assert rows
    _assert_rows_equal(rows, single)
    cluster, _, coord = out["port"]
    assert len(coord.control_log) == 1
    assert coord.registry.state == app.coordinator.registry.state
    for key in ("events", "mapped", "empty", "duplicates"):
        assert sum(a.stats[key] for a in cluster.apps) == app.stats[key], key
    if mode != "blocks":  # one fused dispatch a chunk on every instance
        for k, a in enumerate(cluster.apps):
            assert a.stats["dispatches"] == len(range(k, n_chunks, 4)), k
    assert cluster.info()["states"] == [coord.registry.state]
    cluster.close()


@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_cluster_equals_single_fused_instance(device_densify):
    """Every instance on the sharded engine over one 4-shard CPU mesh: the
    merged rows equal one fused port instance (held to the reference
    above)."""
    coord = _world(91)["port"]
    sink = T.CollectSink()
    cluster = T.Cluster.over_stream(
        coord, T.EventSource(coord.registry, seed=7), instances=2, chunk_size=64,
        max_chunks=8, control={4: _evolve(T, coord.registry)}, sinks=[sink],
        engine="sharded", mesh=make_etl_mesh(devices=["cpu"] * 4), device="cpu",
        device_densify=device_densify, async_consume=True)
    st = cluster.run()
    assert st.chunks == 8 and st.control == 1
    single, _ = _single_rows(91, 8, 64, 4)
    _assert_rows_equal(sink.rows, single)
    info = cluster.info()
    assert info["engine"] == "sharded" and info["dispatches"] == 8
    assert all(i["n_shards"] == 4 for i in info["per_instance"])


def test_cluster_info_matches_reference():
    out = _clusters(92, instances=3, chunk_size=32, max_chunks=6)
    for cluster, _, _ in out.values():
        cluster.run()
    r_info, t_info = out["ref"][0].info(), out["port"][0].info()
    assert sorted(t_info) == sorted(r_info)
    for key, want in r_info.items():
        if key != "per_instance":
            assert t_info[key] == want, key
    coord = out["port"][2]
    assert t_info["instances"] == 3 and t_info["engine"] == "fused"
    assert t_info["state"] == coord.registry.state and t_info["states"] == [coord.registry.state]
    assert t_info["dispatches"] == sum(i["dispatches"] for i in t_info["per_instance"]) == 6
    assert t_info["events"] == 6 * 32 and t_info["dead_letter"] == 0
    assert (t_info["role"], t_info["term"], t_info["lag_records"]) == ("leader", 0, 0)
    assert len(t_info["per_instance"]) == 3
    for ti, ri in zip(t_info["per_instance"], r_info["per_instance"]):
        for key in ("dispatches", "transfers", "state", "n_blocks", "table_bytes",
                    "bytes_resident", "plan_epoch", "rebuilds", "role"):
            assert ti[key] == ri[key], key
        assert ti["device"] == "cpu"


def test_cluster_backpressure_resume_loses_nothing():
    out = _clusters(93, sink_limit=60, instances=2, chunk_size=50, max_chunks=6,
                    evolve_at=3)
    sts = {}
    for side, (cluster, sink, _) in out.items():
        st1 = cluster.run()
        assert sink.full() and st1.chunks < 6
        sink.limit = None
        st2 = cluster.run()
        assert st1.chunks + st2.chunks == 6
        sts[side] = [dataclasses.asdict(st1), dataclasses.asdict(st2)]
    assert sts["port"] == sts["ref"]
    rows = _assert_clusters_equal(out)
    _assert_rows_equal(rows, _single_rows(93, 6, 50, 3)[0])


def test_cluster_async_backpressure_keeps_each_instance_pending():
    """Async instances under a shared bounded sink: the stopped instance's
    lookahead is kept and mapped on resume, as the reference does."""
    out = _clusters(93, sink_limit=60, instances=2, chunk_size=50, max_chunks=6,
                    evolve_at=3, async_consume=True)
    for cluster, sink, _ in out.values():
        cluster.run()
        sink.limit = None
        cluster.run()
    rows = _assert_clusters_equal(out)
    assert len(rows) > 60


def test_cluster_cross_instance_dead_letter_replay():
    """Every event stamped with the previous state dead-letters; once the
    producer is fixed, replay_dead_letters rewinds each owner's source and
    the re-sliced events map, in the reference's order."""
    out = _clusters(94, instances=2, chunk_size=32, max_chunks=4,
                    stream_kwargs=dict(p_stale=1.0, p_duplicate=0.0))
    reps = {}
    for side, (cluster, sink, _) in out.items():
        st = cluster.run()
        assert st.chunks == 4 and sink.rows == []
        assert cluster.info()["dead_letter"] == 4 * 32
        for src in cluster.sources:
            src.source.p_stale = 0.0  # the producer is fixed
        rep = cluster.replay_dead_letters()
        assert rep.chunks == 4 and cluster.info()["dead_letter"] == 0
        reps[side] = dataclasses.asdict(rep)
    assert reps["port"] == reps["ref"]
    rows = _assert_clusters_equal(out)
    coord = _world(94)["port"]
    app = T.METLApp(coord, device="cpu")
    src = T.EventSource(coord.registry, seed=7, p_duplicate=0.0)
    _assert_rows_equal(rows, [r for k in range(4)
                              for r in app.consume(src.slice_columnar(k * 32, 32))])


def test_cluster_refusals():
    coord = _world(95)["port"]
    stream = T.EventSource(coord.registry, seed=7)
    src = T.EventChunkSource(stream, chunk_size=32, max_chunks=2)
    cluster = T.Cluster(coord, [src], [T.CollectSink()], device="cpu")
    cluster.run()
    with pytest.raises(RuntimeError, match="chunk grid"):
        cluster.replay_dead_letters()
    srcs = [T.EventChunkSource(stream, chunk_size=32, max_chunks=1, stride=2, offset=k)
            for k in range(2)]
    with pytest.raises(ValueError, match="cannot be shared"):
        T.Cluster(coord, srcs, [T.CollectSink()], engine=T.FusedEngine(device="cpu"))
    with pytest.raises(ValueError, match="at least one source"):
        T.Cluster(coord, [], [T.CollectSink()], device="cpu")
    with pytest.raises(ValueError, match="instances must be"):
        T.Cluster.over_stream(coord, stream, instances=0, device="cpu")


def test_cluster_applies_a_shared_event_once_and_closes():
    coord = _world(96)["port"]
    sink = T.CollectSink()
    ev = _evolve(T, coord.registry)
    cluster = T.Cluster.over_stream(coord, T.EventSource(coord.registry, seed=7),
                                    instances=2, chunk_size=32, max_chunks=4,
                                    sinks=[sink], device="cpu", async_consume=True)
    cluster.apply_control(ev)
    cluster.apply_control(ev)  # the same object: applied once
    assert len(coord.control_log) == 1
    cluster.run(max_rounds=2)
    st = cluster.run()
    assert st.chunks == 2 and st.rounds >= 2
    cluster.close()
    assert all(p._pool is None for p in cluster.pipelines)


# ---------------------------------------------------------------------------
# initial_load
# ---------------------------------------------------------------------------


def _load_pair(seed, n, **kwargs):
    out = {}
    for side, coord in _world(seed).items():
        E = SIDES[side]
        src = E.EventSource(coord.registry, seed=4, p_duplicate=0.0)
        load = initial_load if side == "port" else r_initial_load
        out[side] = load(coord, src, instances=n, **_kw(side, **kwargs))
    return out


@pytest.mark.parametrize("instances", [1, 2, 4])
def test_initial_load_matches_reference(instances):
    out = _load_pair(71, instances, start=0, count=512, chunk=100)
    _assert_rows_equal(out["port"], out["ref"])
    assert len(out["port"]) > 0


def test_initial_load_is_instance_count_invariant():
    one = _load_pair(72, 1, count=512)["port"]
    four = _load_pair(72, 4, count=512)["port"]

    def key(r):
        return (r[3], r[0])

    _assert_rows_equal(sorted(four, key=key), sorted(one, key=key))


@pytest.mark.parametrize("instances", [2, 4])
def test_initial_load_threads_equal_sequential(instances):
    coord = _world(73)["port"]
    src = T.EventSource(coord.registry, seed=5, p_duplicate=0.0)
    seq = initial_load(coord, src, count=640, instances=instances, chunk=64,
                       threads=False, device="cpu")
    par = initial_load(coord, src, count=640, instances=instances, chunk=64,
                       threads=True, device="cpu")
    assert seq
    _assert_rows_equal(par, seq)
    assert not coord.frozen


def test_initial_load_thaws_after_a_failure():
    """The load freezes the coordinator and thaws it in ``finally``: a
    failing instance leaves it mutable, and a schema change applies."""
    coord = _world(74)["port"]
    src = T.EventSource(coord.registry, seed=6)
    coord.freeze()
    with pytest.raises(RuntimeError):
        coord.apply_update(lambda reg: ("deleted_domain", 0, 1))
    coord.thaw()
    stale = T.EventSource(coord.registry, seed=6, p_stale=1.0)
    with pytest.raises(Exception, match="state"):  # strict_state: stale events raise
        initial_load(coord, stale, count=64, instances=2, device="cpu")
    assert not coord.frozen
    initial_load(coord, src, count=64, instances=2, device="cpu")
    assert not coord.frozen
    ev = _evolve(T, coord.registry)
    coord.apply(ev)
    assert coord.control_log[-1].event is ev
