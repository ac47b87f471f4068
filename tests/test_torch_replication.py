"""The port's replicated control plane against the reference, on the CPU.

Counterparts of every test of ``tests/test_replication.py`` (codec round
trips, fencing, catch-up, the Cluster oracle, election, promotion,
exactly-once restart, dedup, ``replication_info``, the follower's engine
info and plan manager), run on ``repro_torch.etl.replication`` with every
data plane on ``device="cpu"``; then the wire held byte for byte against
the reference's (events, records, snapshots, rows, as JSON with sorted
keys) and decoded across packages; runs that mix a reference leader with
port followers and the reverse, in process and as processes; the four acts
of ``scripts/replication_smoke.py --fast`` through the port's command line;
the port-side single-writer guard; and ``chip_smoke.py`` phase 4d's
multi-process and failover runs, rehearsed on the CPU at a small size.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import repro.etl as R
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig as RConfig
from repro.core.synthetic import build_scenario as r_build_scenario
from repro.core.synthetic import churn_schedule as r_churn_schedule
import repro.etl.replication as RR
import repro.etl.transport as RT

import repro_torch.etl as T
import repro_torch.etl.transport as TT
from repro_torch.core.registry import Registry
from repro_torch.core.state import ClosureUpdate, StateCoordinator
from repro_torch.core.synthetic import ScenarioConfig, build_scenario, churn_schedule
from repro_torch.etl import CollectSink, Cluster, EventSource
from repro_torch.etl.control import (
    ControlReplayError,
    Freeze,
    MatrixEdit,
    PlanPublished,
    SchemaAdded,
    SchemaEvolved,
    Thaw,
    VersionDeleted,
    replay_control_log,
)
from repro_torch.etl.replication import (
    END_OF_STREAM,
    ControlLedger,
    DataPlane,
    FencedAppendError,
    FollowerNode,
    LeaderNode,
    elect_leader,
    load_restart,
    promote,
)
from repro_torch.etl.transport import (
    decode_event,
    decode_record,
    decode_snapshot,
    encode_event,
    encode_record,
    encode_snapshot,
    local_pipe,
    row_to_wire,
)

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))
PORT_CLI = [sys.executable, "-m", "repro_torch.etl.replication"]
REF_CLI = [sys.executable, "-m", "repro.etl.replication"]
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _scenario(seed=7, n_schemas=4):
    return build_scenario(
        ScenarioConfig(n_schemas=n_schemas, versions_per_schema=2, seed=seed)
    )


def _ref_scenario(seed=7, n_schemas=4):
    return r_build_scenario(RConfig(n_schemas=n_schemas, versions_per_schema=2, seed=seed))


def _schedule(sc, *, steps=3, first=1, every=2, freeze_at=None, thaw_at=None,
              side=None):
    """The churn schedule with an optional Freeze/Thaw window, built from
    ``side``'s package (the port's by default)."""
    churn_fn, E = (r_churn_schedule, R) if side == "ref" else (churn_schedule, T)
    churn = churn_fn(sc.registry, steps=steps, first_chunk=first, every=every, seed=11)
    sched = {k: [v] for k, v in churn.items()}
    if freeze_at is not None:
        sched.setdefault(freeze_at, []).insert(0, E.Freeze())
    if thaw_at is not None:
        sched.setdefault(thaw_at, []).append(E.Thaw())
    return sched


def _attach_pair(leader, follower_cls=FollowerNode, pipe=local_pipe):
    """A pipe + the blocking attach/subscribe handshake, in-process."""
    end_l, end_f = pipe()
    t = threading.Thread(target=leader.attach, args=(end_l,))
    t.start()
    fol = follower_cls(end_f, node_id=1 + len(leader.followers))
    fol.subscribe()
    t.join(timeout=30)
    assert not t.is_alive()
    return fol


# ------------------------------------------------------------------ codec

EVENT_ARGS = [
    ("SchemaAdded", dict(tree="domain", schema_id=90, names=("a", "b"), version=1)),
    ("SchemaEvolved", dict(tree="domain", schema_id=0, keep=("x",), add=("y", "z"))),
    ("VersionDeleted", dict(tree="range", schema_id=1, version=1)),
    ("MatrixEdit", dict(dpm={(0, 1, 2, 1): frozenset({(5, 7), (6, 8)})})),
    ("Freeze", {}),
    ("Thaw", {}),
    ("PlanPublished", dict(epoch=3, state=9, kind="fused", incremental=True,
                           touched_columns=2, n_blocks=11, bytes_resident=4096,
                           rebuild_s=0.25)),
]
EVENTS = [getattr(T, name)(**kw) for name, kw in EVENT_ARGS]
_ids = [name for name, _ in EVENT_ARGS]


@pytest.mark.parametrize("event", EVENTS, ids=_ids)
def test_codec_roundtrips_every_event(event):
    wire = encode_event(event)
    back = decode_event(json.loads(json.dumps(wire)))  # through real JSON
    assert type(back) is type(event)
    if isinstance(event, MatrixEdit):
        assert back.dpm == event.dpm
    else:
        assert back == event


def test_codec_rejects_closure_update_at_the_boundary():
    ev = ClosureUpdate(lambda reg: ("added_domain", 0, 1))
    with pytest.raises(ControlReplayError):
        encode_event(ev)


def test_registry_snapshot_roundtrip_preserves_uid_sequence():
    sc = _scenario()
    reg = Registry.from_dict(sc.registry.to_dict())
    assert reg.to_dict() == sc.registry.to_dict()
    # uid continuity: the SAME evolution issues the SAME uids on both
    keep = tuple(
        a.name
        for a in sc.registry.domain.get(
            0, sc.registry.domain.latest_version(0)
        ).attributes
    )[:2]
    ev = SchemaEvolved(tree="domain", schema_id=0, keep=keep, add=("fresh",))
    ev.mutate(sc.registry)
    ev.mutate(reg)
    assert reg.to_dict() == sc.registry.to_dict()


def test_coordinator_snapshot_roundtrip_carries_log_offset():
    sc = _scenario()
    coord = StateCoordinator(sc.registry, sc.dpm)
    coord.apply(SchemaAdded(tree="domain", schema_id=91, names=("n1",)))
    snap = encode_snapshot(coord)
    twin = decode_snapshot(json.loads(json.dumps(snap)))
    assert twin.registry.to_dict() == coord.registry.to_dict()
    assert twin.snapshot().dpm == coord.snapshot().dpm
    assert twin.log_offset == coord.log_offset == 1


# ----------------------------------------------------------------- ledger


def _wire(seq, term, state=1):
    rec_coord = StateCoordinator(Registry())
    rec_coord.apply(SchemaAdded(tree="domain", schema_id=50 + seq, names=("a",)))
    w = encode_record(rec_coord.control_log[0], term=term, at=0)
    w["seq"], w["state"] = seq, state
    return w


def test_ledger_fences_stale_term_appends():
    led = ControlLedger()
    led.open_term(2)
    with pytest.raises(FencedAppendError):
        led.commit(_wire(0, term=1))
    led.commit(_wire(0, term=2))
    # a zombie writer from term 1 stays fenced even mid-log
    with pytest.raises(FencedAppendError):
        led.commit(_wire(1, term=1))
    with pytest.raises(FencedAppendError):
        led.open_term(2)  # non-advancing term is itself stale


def test_ledger_rejects_seq_gaps_and_truncates(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    led = ControlLedger(path=path)
    led.open_term(1)
    led.commit(_wire(0, term=1))
    with pytest.raises(FencedAppendError):
        led.commit(_wire(2, term=1))
    led.commit(_wire(1, term=1))
    assert led.offset == 2
    led.truncate(1)
    assert led.offset == 1
    again = ControlLedger.load(path)
    assert again.offset == 1 and again.term == 1


# ------------------------------------------------ follower-side fencing


def test_follower_drops_stale_term_records():
    sc = _scenario()
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=3)
    fol = _attach_pair(leader)
    assert fol.term == 3
    fol._dispatch({"t": "rec", **_wire(0, term=2)})
    assert fol.rejected_stale == 1 and fol.lag_records == 0
    fol._dispatch({"t": "hb", "term": 1, "frontier": 99, "log_offset": 0})
    assert fol.rejected_stale == 2 and fol.frontier < 99


# ----------------------------------------- catch-up bit-exactness


def _apply_history(leader, E=T):
    """Schema churn + a Freeze/Thaw window with deferred churn inside +
    PlanPublished cutovers, through the leader's replicated apply (events
    from package ``E``, the leader's own)."""
    reg = leader.coordinator.registry
    keep0 = tuple(
        a.name for a in reg.domain.get(0, reg.domain.latest_version(0)).attributes
    )[:3]
    leader.apply(E.SchemaEvolved(tree="domain", schema_id=0, keep=keep0, add=("c0",)))
    leader.apply(E.PlanPublished(epoch=1, state=reg.state, kind="fused"))
    leader.apply(E.Freeze())
    # deferred inside the window: queued, unlogged, re-admitted by Thaw
    keep1 = tuple(
        a.name for a in reg.domain.get(1, reg.domain.latest_version(1)).attributes
    )[:2]
    leader.apply(
        E.SchemaEvolved(tree="domain", schema_id=1, keep=keep1, add=("c1",)),
        defer_frozen=True,
    )
    leader.apply(E.PlanPublished(epoch=2, state=reg.state, kind="fused"))
    leader.apply(E.Thaw())
    leader.apply(E.PlanPublished(epoch=3, state=reg.state, kind="fused"))


def test_catch_up_from_offset_matches_full_replay():
    sc = _scenario(seed=13)
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    _apply_history(leader)

    # snapshot mid-history at a nonzero offset, then more history
    mid = coord.log_offset
    snap = encode_snapshot(coord)
    reg = coord.registry
    keep2 = tuple(
        a.name for a in reg.domain.get(2, reg.domain.latest_version(2)).attributes
    )[:2]
    leader.apply(SchemaEvolved(tree="domain", schema_id=2, keep=keep2, add=("c2",)))
    leader.apply(PlanPublished(epoch=4, state=reg.state, kind="fused"))
    assert mid > 0 and coord.log_offset > mid

    # catch-up: seed snapshot + suffix replay from the nonzero offset
    partial = decode_snapshot(json.loads(json.dumps(snap)))
    assert partial.log_offset == mid
    suffix = [
        decode_record(json.loads(json.dumps(w)))["record"]
        for w in leader.ledger.records(frm=mid)
    ]
    replay_control_log(suffix, coordinator=partial)

    # oracle: full replay over the deterministic seed
    sc2 = _scenario(seed=13)
    full = replay_control_log(
        [decode_record(w)["record"] for w in leader.ledger.records()],
        sc2.registry,
        sc2.dpm,
    )

    for twin in (partial, full):
        assert twin.registry.to_dict() == coord.registry.to_dict()
        assert twin.snapshot().dpm == coord.snapshot().dpm
        assert twin.log_offset == coord.log_offset
    # the deferred-evolution record only exists PAST the Thaw record
    ops = [w["event"]["type"] for w in leader.ledger.records()]
    assert ops.index("Thaw") < ops.index("SchemaEvolved", ops.index("Freeze"))


def test_replay_contiguity_rejects_gaps():
    sc = _scenario()
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    _apply_history(leader)
    records = [decode_record(w)["record"] for w in leader.ledger.records()]
    partial = decode_snapshot(encode_snapshot(StateCoordinator(
        _scenario().registry, _scenario().dpm
    )))
    with pytest.raises(ControlReplayError, match="gap"):
        replay_control_log(records[1:], coordinator=partial)


# ------------------------------- leader + 2 followers vs Cluster oracle


def _rows_wire(rows):
    return [row_to_wire(r) for r in rows]


# test_leader_two_followers_match_cluster_oracle's grid
N, MAX_CHUNKS, CHUNK = 3, 9, 48
WINDOW = dict(steps=3, first=2, every=2, freeze_at=3, thaw_at=6)


def _ref_cluster_oracle():
    """The reference's single-process lockstep Cluster over the grid."""
    osc = _ref_scenario(seed=21, n_schemas=5)
    ocoord = RCoordinator(osc.registry, osc.dpm)
    osink = R.CollectSink()
    R.Cluster.over_stream(
        ocoord, R.EventSource(osc.registry, seed=5), instances=N,
        chunk_size=CHUNK, max_chunks=MAX_CHUNKS,
        control=_schedule(osc, side="ref", **WINDOW), sinks=[osink],
    ).run()
    return ocoord, osink.rows


def _port_plane(coord, slot):
    return DataPlane(coord, EventSource(coord.registry, seed=5), slot=slot, instances=N,
                     chunk_size=CHUNK, max_chunks=MAX_CHUNKS, device="cpu")


def _ref_plane(coord, slot):
    return RR.DataPlane(coord, R.EventSource(coord.registry, seed=5), slot=slot,
                        instances=N, chunk_size=CHUNK, max_chunks=MAX_CHUNKS)


def test_leader_two_followers_match_cluster_oracle():
    sc = _scenario(seed=21, n_schemas=5)

    # oracle: the port's single-process lockstep Cluster over the same grid
    osc = _scenario(seed=21, n_schemas=5)
    ocoord = StateCoordinator(osc.registry, osc.dpm)
    osink = CollectSink()
    Cluster.over_stream(
        ocoord, EventSource(osc.registry, seed=5), instances=N,
        chunk_size=CHUNK, max_chunks=MAX_CHUNKS, control=_schedule(osc, **WINDOW),
        sinks=[osink], device="cpu",
    ).run()

    # replicated: leader on slot 0, followers on slots 1/2, same grid
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    leader.set_schedule(_schedule(sc, **WINDOW))
    f1 = _attach_pair(leader)
    f2 = _attach_pair(leader)
    by_chunk = {}
    keep = lambda h, rows: by_chunk.__setitem__(h, rows)  # noqa: E731
    leader.run(_port_plane(coord, 0), on_chunk=keep)
    leader.finish(end=MAX_CHUNKS - 1)
    for slot, fol in ((1, f1), (2, f2)):
        fol.run(_port_plane(fol.coordinator, slot), on_chunk=keep)
        fol.finish()
        assert fol.coordinator.registry.to_dict() == coord.registry.to_dict()

    merged = [r for h in sorted(by_chunk) for r in by_chunk[h]]
    assert sorted(by_chunk) == list(range(MAX_CHUNKS))
    assert ocoord.registry.state == coord.registry.state
    assert len(merged) == len(osink.rows)
    assert _rows_wire(merged) == _rows_wire(osink.rows)
    # and the reference's oracle, row for row
    rcoord, rrows = _ref_cluster_oracle()
    assert rcoord.registry.to_dict() == coord.registry.to_dict()
    assert _rows_wire(merged) == _rows_wire(rrows)


# -------------------------------------------- election / promotion


def test_election_prefers_longest_log_and_promote_fences_the_zombie():
    sc = _scenario(seed=31)
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    f1 = _attach_pair(leader)
    f2 = _attach_pair(leader)
    # f2's link dies silently before the history tail ships: only f1 sees it
    leader.followers = leader.followers[:1]
    _apply_history(leader)
    f1.pump()
    f2.pump()
    assert f1.coordinator.log_offset + f1.lag_records > (
        f2.coordinator.log_offset + f2.lag_records
    )

    assert elect_leader([f1, f2]) is f1
    new = promote(f1, term=2)
    # promotion replayed the pending suffix first
    assert new.coordinator.registry.to_dict() == coord.registry.to_dict()
    assert new.term == 2 and new.coordinator.log_offset == coord.log_offset

    # the zombie's stale term can no longer append to the new ledger
    stale = encode_record(coord.control_log[-1], term=1, at=0)
    stale["seq"] = new.ledger.offset
    with pytest.raises(FencedAppendError):
        new.ledger.commit(stale)
    # and a promotion that does not advance the term is itself fenced
    with pytest.raises(FencedAppendError):
        promote(f2, term=1)


def test_promoted_leader_reseeds_late_joiners():
    sc = _scenario(seed=33)
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    f1 = _attach_pair(leader)
    _apply_history(leader)
    f1.pump()
    new = promote(f1, term=2)
    cold = _attach_pair(new)
    assert cold.term == 2
    cold.advance_to(END_OF_STREAM)
    assert cold.coordinator.registry.to_dict() == coord.registry.to_dict()


# ------------------------------------------- exactly-once restart


def test_exactly_once_restart_zero_dropped_zero_duplicated(tmp_path):
    n, max_chunks, chunk_size = 2, 8, 48
    ledger_path = str(tmp_path / "ledger.jsonl")
    ck_path = str(tmp_path / "restart.json")

    def mk(seed=41):
        sc = _scenario(seed=seed, n_schemas=5)
        return sc, _schedule(sc, steps=3, first=1, every=2)

    def plane(coord, reg, **kw):
        return DataPlane(coord, EventSource(reg, seed=6), slot=0, instances=1,
                         chunk_size=chunk_size, max_chunks=max_chunks, device="cpu", **kw)

    # oracle: one uninterrupted leader over the full grid
    osc, osched = mk()
    ocoord = StateCoordinator(osc.registry, osc.dpm)
    oracle = LeaderNode(ocoord, term=1)
    oracle.set_schedule(osched)
    orows = {}
    oracle.run(plane(ocoord, osc.registry),
               on_chunk=lambda h, rows: orows.__setitem__(h, rows))
    oracle.finish(end=max_chunks - 1)

    # crashing leader: checkpoint every chunk, die after chunk 3's emit
    sc, sched = mk()
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(
        coord, term=1, ledger=ControlLedger(path=ledger_path),
        checkpoint_path=ck_path,
    )
    leader.set_schedule(sched)
    got = {}

    class Crash(RuntimeError):
        pass

    def until_crash(h, rows):
        got[h] = rows
        if len(got) == 3:
            raise Crash()  # dies AFTER emitting, BEFORE that checkpoint

    with pytest.raises(Crash):
        leader.run(plane(coord, sc.registry), on_chunk=until_crash, checkpoint_every=1)

    # chunk 3 was emitted but never checkpointed: exactly-once discards it
    ck = load_restart(ck_path)
    assert ck["chunks_done"] == 2
    got = {h: got[h] for h in sorted(got)[: ck["chunks_done"]]}

    # restart: truncate the ledger to the checkpoint, replay over the
    # deterministic seed, resume the source at the checkpointed offset
    sc2, sched2 = mk()
    ledger = ControlLedger.load(ledger_path)
    ledger.truncate(int(ck["log_offset"]))
    coord2 = replay_control_log(
        [decode_record(w)["record"] for w in ledger.records()],
        sc2.registry, sc2.dpm,
    )
    leader2 = LeaderNode(
        coord2, term=int(ck["term"]) + 1, ledger=ledger, checkpoint_path=ck_path
    )
    leader2.set_schedule(sched2, applied_to=int(ck["source_offset"]) - 1)
    leader2.run(plane(coord2, sc2.registry, skip_chunks=int(ck["chunks_done"])),
                on_chunk=lambda h, rows: got.__setitem__(h, rows))
    leader2.finish(end=max_chunks - 1)

    assert sorted(got) == sorted(orows) == list(range(max_chunks))
    for h in orows:  # zero dropped, zero duplicated, bit-identical rows
        assert _rows_wire(got[h]) == _rows_wire(orows[h]), f"chunk {h}"
    assert coord2.registry.to_dict() == ocoord.registry.to_dict()
    assert leader2.term == 2


def test_follower_dedups_reshipped_records_across_restart():
    sc = _scenario(seed=43)
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    fol = _attach_pair(leader)
    _apply_history(leader)
    fol.pump()
    held = fol.coordinator.log_offset + fol.lag_records

    # a restarted leader (same history, new term) re-ships its whole log
    for wire in leader.ledger.records():
        fol._dispatch({"t": "rec", **dict(wire, term=2)})
    assert fol.coordinator.log_offset + fol.lag_records == held  # no dupes
    fol.advance_to(END_OF_STREAM)
    assert fol.coordinator.registry.to_dict() == coord.registry.to_dict()


# ------------------------------------------------ info() contract


def test_replication_info_roles_and_lag():
    sc = _scenario(seed=51)
    coord = StateCoordinator(sc.registry, sc.dpm)
    assert coord.replication_info() == {
        "role": "leader", "term": 0, "log_offset": 0, "lag_records": 0,
    }
    leader = LeaderNode(coord, term=4)
    info = coord.replication_info()
    assert info["role"] == "leader" and info["term"] == 4
    assert coord.is_control_writer

    fol = _attach_pair(leader)
    _apply_history(leader)
    fol.pump()
    finfo = fol.coordinator.replication_info()
    assert finfo["role"] == "follower" and finfo["term"] == 4
    assert finfo["lag_records"] == fol.lag_records > 0
    assert finfo["log_offset"] == 0  # nothing applied until the cursor moves
    assert not fol.coordinator.is_control_writer
    fol.advance_to(END_OF_STREAM)
    assert fol.coordinator.replication_info()["lag_records"] == 0
    assert fol.coordinator.replication_info()["log_offset"] == coord.log_offset


def test_follower_engine_info_reports_follower_role():
    sc = _scenario(seed=53)
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    fol = _attach_pair(leader)
    plane = DataPlane(
        fol.coordinator, EventSource(fol.coordinator.registry, seed=5),
        slot=0, instances=1, chunk_size=32, max_chunks=1, device="cpu",
    )
    leader.advance(0)
    fol.pump()
    fol.advance_to(0)
    assert plane.step() is not None
    info = plane.app.engine.info()
    assert info["role"] == "follower" and info["term"] == 1
    assert info["lag_records"] == 0


def test_follower_plan_manager_never_publishes_to_the_replica_log():
    """A follower-bound PlanManager with publish=True keeps epochs local:
    is_control_writer gates the PlanPublished injection."""
    from repro_torch.etl.plan import PlanManager

    sc = _scenario(seed=55)
    coord = StateCoordinator(sc.registry, sc.dpm)
    leader = LeaderNode(coord, term=1)
    fol = _attach_pair(leader)
    mgr = PlanManager(kind="fused", device="cpu", coordinator=fol.coordinator,
                      publish=True)
    snap = fol.coordinator.snapshot()
    lease = mgr.acquire(snap, fol.coordinator.registry)
    assert lease.epoch == 1
    # the epoch is live locally, but NO PlanPublished entered the replica log
    assert fol.coordinator.log_offset == coord.log_offset
    assert [type(r.event).__name__ for r in fol.coordinator.control_log] == [
        type(r.event).__name__ for r in coord.control_log
    ]


# ------------------------------------------- the wire against the reference


def _dumps(obj):
    return json.dumps(obj, sort_keys=True)


@pytest.mark.parametrize("name,kw", EVENT_ARGS, ids=_ids)
def test_event_wire_equals_the_reference(name, kw):
    mine = TT.encode_event(getattr(T, name)(**kw))
    theirs = RT.encode_event(getattr(R, name)(**kw))
    assert _dumps(mine) == _dumps(theirs)
    assert json.dumps(mine) == json.dumps(theirs)  # key order too
    # each package decodes the other's wire to an equal event
    back_t, back_r = TT.decode_event(theirs), RT.decode_event(mine)
    assert type(back_t).__name__ == type(back_r).__name__ == name
    if name == "MatrixEdit":
        assert back_t.dpm == back_r.dpm == kw["dpm"]
    else:
        assert TT.encode_event(back_t) == mine and RT.encode_event(back_r) == theirs


def _twin_leaders(seed=61):
    """A reference and a port leader over one scenario, each driven
    through churn and a Freeze/Thaw window with deferred churn inside."""
    rsc = _ref_scenario(seed=seed, n_schemas=5)
    tsc = _scenario(seed=seed, n_schemas=5)
    assert rsc.registry.to_dict() == tsc.registry.to_dict()
    rl = RR.LeaderNode(RCoordinator(rsc.registry, rsc.dpm), term=2)
    tl = LeaderNode(StateCoordinator(tsc.registry, tsc.dpm), term=2)
    for leader, E in ((rl, R), (tl, T)):
        _apply_history(leader, E)
        for at, ev in _schedule(leader.coordinator, side="ref" if E is R else None,
                                steps=2, first=4, every=1).items():
            leader.apply(ev[0], at=at)
    return rl, tl


def test_record_and_snapshot_wire_equal_the_reference():
    rl, tl = _twin_leaders()
    assert len(tl.ledger.records()) == len(rl.ledger.records()) > 8
    assert _dumps(tl.ledger.records()) == _dumps(rl.ledger.records())
    for rec_t, rec_r in zip(tl.coordinator.control_log, rl.coordinator.control_log):
        assert _dumps(TT.encode_record(rec_t, term=2, at=5)) == _dumps(
            RT.encode_record(rec_r, term=2, at=5))
    assert _dumps(TT.encode_snapshot(tl.coordinator)) == _dumps(
        RT.encode_snapshot(rl.coordinator))
    # a frozen coordinator's snapshot too
    rl.apply(R.Freeze())
    tl.apply(Freeze())
    snap_t, snap_r = TT.encode_snapshot(tl.coordinator), RT.encode_snapshot(rl.coordinator)
    assert snap_t["frozen"] and _dumps(snap_t) == _dumps(snap_r)


def test_each_package_decodes_the_others_wire():
    rl, tl = _twin_leaders(seed=63)
    for snap, decode, want in (
        (RT.encode_snapshot(rl.coordinator), TT.decode_snapshot, tl.coordinator),
        (TT.encode_snapshot(tl.coordinator), RT.decode_snapshot, rl.coordinator),
    ):
        twin = decode(json.loads(json.dumps(snap)))
        assert twin.registry.to_dict() == want.registry.to_dict()
        assert twin.snapshot().dpm == want.snapshot().dpm
        assert twin.log_offset == want.log_offset and twin.frozen == want.frozen
    # records: the reference's log replayed by the port over the seed, and back
    for wires, decode, replay, build, want in (
        (rl.ledger.records(), TT.decode_record, replay_control_log, _scenario,
         tl.coordinator),
        (tl.ledger.records(), RT.decode_record, R.replay_control_log, _ref_scenario,
         rl.coordinator),
    ):
        sc = build(seed=63, n_schemas=5)
        got = replay([decode(json.loads(json.dumps(w)))["record"] for w in wires],
                     sc.registry, sc.dpm)
        assert got.registry.to_dict() == want.registry.to_dict()
        assert got.snapshot().dpm == want.snapshot().dpm
        assert got.log_offset == want.log_offset


def test_row_wire_equals_the_reference():
    """Canonical rows of one chunk, consumed by each package from one
    state, give the same row wire; decoded rows are float64, as the
    reference's are."""
    import numpy as np

    rl, tl = _twin_leaders(seed=65)
    rrows = RR.DataPlane(rl.coordinator, R.EventSource(rl.coordinator.registry, seed=3),
                         chunk_size=64, max_chunks=2).step()
    trows = DataPlane(tl.coordinator, EventSource(tl.coordinator.registry, seed=3),
                      chunk_size=64, max_chunks=2, device="cpu").step()
    assert rrows[0] == trows[0] and len(trows[1]) > 0
    assert _dumps(_rows_wire(trows[1])) == _dumps([RT.row_to_wire(r) for r in rrows[1]])
    back = TT.row_from_wire(json.loads(json.dumps(row_to_wire(trows[1][0]))))
    assert back[1].dtype == np.float64 == RT.row_from_wire(
        json.loads(json.dumps(RT.row_to_wire(rrows[1][0]))))[1].dtype


# ------------------------------------------- mixed runs in one process


def test_reference_leader_with_port_followers_matches_cluster_oracle():
    """A reference LeaderNode over the reference's local_pipe feeds two port
    FollowerNodes on the CPU; merged rows equal the reference oracle."""
    rsc = _ref_scenario(seed=21, n_schemas=5)
    leader = RR.LeaderNode(RCoordinator(rsc.registry, rsc.dpm), term=1)
    leader.set_schedule(_schedule(rsc, side="ref", **WINDOW))
    followers = [_attach_pair(leader, FollowerNode, RT.local_pipe) for _ in range(2)]
    by_chunk = {}
    keep = lambda h, rows: by_chunk.__setitem__(h, rows)  # noqa: E731
    leader.run(_ref_plane(leader.coordinator, 0), on_chunk=keep)
    leader.finish(end=MAX_CHUNKS - 1)
    for slot, fol in enumerate(followers, start=1):
        fol.run(_port_plane(fol.coordinator, slot), on_chunk=keep)
        fol.finish()
        assert fol.coordinator.registry.to_dict() == leader.coordinator.registry.to_dict()
        assert fol.coordinator.log_offset == leader.coordinator.log_offset
    merged = [r for h in sorted(by_chunk) for r in by_chunk[h]]
    assert sorted(by_chunk) == list(range(MAX_CHUNKS))
    _, rrows = _ref_cluster_oracle()
    assert _rows_wire(merged) == _rows_wire(rrows)


def test_port_leader_with_reference_follower_matches_cluster_oracle():
    sc = _scenario(seed=21, n_schemas=5)
    leader = LeaderNode(StateCoordinator(sc.registry, sc.dpm), term=1)
    leader.set_schedule(_schedule(sc, **WINDOW))
    ref_fol = _attach_pair(leader, RR.FollowerNode, local_pipe)
    port_fol = _attach_pair(leader)
    by_chunk = {}
    keep = lambda h, rows: by_chunk.__setitem__(h, rows)  # noqa: E731
    leader.run(_port_plane(leader.coordinator, 0), on_chunk=keep)
    leader.finish(end=MAX_CHUNKS - 1)
    ref_fol.run(_ref_plane(ref_fol.coordinator, 1), on_chunk=keep)
    ref_fol.finish()
    port_fol.run(_port_plane(port_fol.coordinator, 2), on_chunk=keep)
    port_fol.finish()
    assert ref_fol.coordinator.registry.to_dict() == leader.coordinator.registry.to_dict()
    merged = [r for h in sorted(by_chunk) for r in by_chunk[h]]
    assert sorted(by_chunk) == list(range(MAX_CHUNKS))
    _, rrows = _ref_cluster_oracle()
    assert _rows_wire(merged) == _rows_wire(rrows)


# ------------------------------------------- processes on the CPU


FAST_GRID = smoke.FAILOVER_FAST_GRID


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "replication_smoke", REPO / "scripts" / "replication_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_failover_smoke_acts_through_the_port_cli(capsys):
    """``scripts/replication_smoke.py --fast``'s four acts (oracle; a leader
    killed after 2 chunks with two followers; a term-2 resume; the audit)
    with every process the port's CLI on the CPU."""
    script = _load_script()
    script.CLI = PORT_CLI + ["--device", "cpu"]
    script.ENV = ENV
    script.run_smoke(fast=True)
    out = capsys.readouterr().out
    assert "oracle: 9 chunks" in out
    assert "zero dropped, zero duplicated, bit-exact vs oracle" in out


def test_oracle_file_is_byte_identical_to_the_reference(tmp_path):
    outs = {}
    for name, cli in (("port", PORT_CLI + ["--device", "cpu"]), ("ref", REF_CLI)):
        outs[name] = tmp_path / f"{name}.jsonl"
        subprocess.run(cli + ["--role", "oracle", "--out", str(outs[name])] + FAST_GRID,
                       env=ENV, check=True, timeout=120, capture_output=True)
    data = outs["port"].read_bytes()
    assert data and data == outs["ref"].read_bytes()


def test_reference_leader_process_with_port_follower_processes(tmp_path):
    """A reference leader process feeds two port follower processes over
    the socket transport; the merged rows equal the reference oracle's."""
    script = _load_script()
    grid = FAST_GRID
    oracle = tmp_path / "oracle.jsonl"
    subprocess.run(REF_CLI + ["--role", "oracle", "--out", str(oracle)] + grid,
                   env=ENV, check=True, timeout=120, capture_output=True)
    port = script.free_port()
    outs = [tmp_path / f"f{s}.jsonl" for s in (1, 2)]
    followers = [
        subprocess.Popen(PORT_CLI + ["--role", "follower", "--device", "cpu",
                                     "--port", str(port), "--slot", str(s),
                                     "--instances", "3", "--out", str(out)] + grid,
                         env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, out in zip((1, 2), outs)
    ]
    try:
        leader_out = tmp_path / "leader.jsonl"
        subprocess.run(REF_CLI + ["--role", "leader", "--port", str(port), "--followers",
                                  "2", "--instances", "3", "--out", str(leader_out)] + grid,
                       env=ENV, check=True, timeout=120, capture_output=True)
        logs = [p.communicate(timeout=120) for p in followers]
        assert [p.returncode for p in followers] == [0, 0], logs
    finally:
        for p in followers:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all("stale rejected 0" in out for out, _ in logs)
    got = {}
    for path in [leader_out, *outs]:
        for h, rows in script.read_chunks(str(path)).items():
            assert h not in got
            got[h] = rows
    assert got == script.read_chunks(str(oracle))


# ------------------------------------------- the single-writer guard

COORD_LEAVES = ("coordinator", "coord")
COORD_MAKERS = ("StateCoordinator", "replay_control_log", "decode_snapshot")


def _chain(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def replica_applies(source: str):
    """``<coordinator>.apply(`` / ``.apply_update(`` calls outside
    ``LeaderNode`` in a module of the replicated control plane: the port's
    counterpart of the analyzer's ``_check_replica_apply``.  A receiver is
    coordinator-typed when its dotted name ends in ``coordinator``,
    ``coord``, ``*_coordinator`` or ``*_coord``, or is a local name bound
    from ``StateCoordinator(...)``, ``replay_control_log(...)`` or
    ``decode_snapshot(...)``.  Returns ``[(line, where), ...]``."""
    found = []

    def visit(node, cls, fn):
        if isinstance(node, ast.ClassDef):
            cls = node.name
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("apply", "apply_update") and cls != "LeaderNode":
            recv = _chain(node.func.value) or ""
            leaf = recv.split(".")[-1]
            bound = set()
            for sub in ast.walk(fn) if fn is not None else ():
                if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call) \
                        and (_chain(sub.value.func) or "").split(".")[-1] in COORD_MAKERS:
                    bound |= {t.id for t in sub.targets if isinstance(t, ast.Name)}
            if leaf in COORD_LEAVES or leaf.endswith(("_coordinator", "_coord")) \
                    or recv in bound:
                found.append((node.lineno, f"{cls or ''}.{fn.name if fn else ''}"))
        for child in ast.iter_child_nodes(node):
            visit(child, cls, fn)

    visit(ast.parse(source), None, None)
    return found


@pytest.mark.parametrize("name", ["replication.py", "transport.py"])
def test_only_the_leader_applies_in_the_replicated_modules(name):
    path = REPO / "src" / "repro_torch" / "etl" / name
    assert replica_applies(path.read_text()) == []


@pytest.mark.parametrize("mutation", [
    "        self.coordinator.apply(Thaw())\n",
    "        coord = decode_snapshot({})\n        coord.apply_update(None)\n",
], ids=["attribute", "bound_name"])
def test_single_writer_guard_catches_a_follower_that_applies(mutation):
    src = (REPO / "src" / "repro_torch" / "etl" / "replication.py").read_text()
    anchor = "        return len(due)\n"
    assert src.count(anchor) == 1  # FollowerNode.advance_to's last line
    hits = replica_applies(src.replace(anchor, mutation + anchor))
    assert [where for _, where in hits] == ["FollowerNode.advance_to"]
    # the leader's own apply stays allowed
    assert "self.coordinator.apply(event" in src


# ------------------------------------------- chip_smoke phase 4d, rehearsed

SMALL = ScenarioConfig(n_schemas=6, versions_per_schema=3, seed=11)


def test_chip_smoke_replicated_pass_rehearsal():
    """Phase 4d (a) at a small size on the CPU: an in-process leader and
    three follower processes; merged rows equal one port app's rows over
    the same stream, every follower at the leader's term and offset."""
    want = smoke.run_main_path("cpu", smoke.MAIN_PATHS["host"], SMALL, smoke.Stream(64),
                               n_chunks=8, evolve_at=3)[0]
    result = smoke.replicated_pass("cpu", SMALL, want, chunks=8, chunk_events=64,
                                   evolve_at=3)
    assert result["rows"] == len(want) > 0
    assert result["followers"] == 3 and result["leader_chunks"] == 2


def test_chip_smoke_failover_rehearsal():
    """Phase 4d (b) at the failover smoke's fast size on the CPU: zero
    dropped, zero duplicated, equal to the oracle, recovery timed."""
    result = smoke.failover_acts("cpu", smoke.FAILOVER_FAST_GRID)
    assert result["chunks"] == 9 and result["dropped"] == result["duplicated"] == 0
    assert 0 < result["recovery_to_first_chunk_s"] <= result["recovery_to_end_s"]
