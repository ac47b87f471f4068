"""The port's streaming pipeline and batcher against the reference's, on the CPU.

Both sides start from one state (``coordinator_from_snapshot(
encode_snapshot(coord))``) and build the same scenario through their own
package: ``repro.etl`` on JAX's CPU backend, ``repro_torch.etl`` with
``METLApp(device="cpu")`` (the plain PyTorch versions of the kernels).  The
synthetic sources and ``churn_schedule`` are copies, so each side makes the
same events and control events from the same seeds.  Rows (routes, keys,
values bit for bit, masks, in order), ``PipelineStats`` and every
``app.stats`` counter must be equal.

Covered: sync, async and async with ``densify_thread`` on fused host
densify, fused device densify and ``engine="blocks"``, and sharded (4
shards; the reference on a 4-device CPU mesh in a subprocess); in-band
control through ``EventChunkSource(control=)``, ``ScriptedControlSource``
and a literal ``ListSource`` event; parked-event replay into the sinks,
also from a lazy refresh inside the lookahead's triage; incremental against
full-rebuild plans; a counterpart of each case of ``tests/test_pipeline.py``
and of the pipeline cases of ``tests/test_columnar.py``; the batcher; and
the engines' two host arenas under the double buffer's edge cases, through
a guard that fails if the lookahead ever rewrites an undispatched arena.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

import repro.configs as RC
import repro.core.synthetic as rsyn
import repro.etl as R
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario
from repro.etl.transport import decode_snapshot, encode_snapshot

import repro_torch.configs as TC
import repro_torch.core.synthetic as tsyn
import repro_torch.etl as T
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import engines as tengines
from repro_torch.etl.initial_load import initial_load  # noqa: F401  (import check)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_etl_mesh

from _subproc import run_sub as _run_sub
from test_torch_metl import _assert_rows_equal

run_sub = functools.partial(_run_sub, devices=4)
TESTS = Path(__file__).resolve().parent
SIDES = {"ref": (R, rsyn), "port": (T, tsyn)}
# the engine configurations of the pipeline, as METLApp keywords
MODES = {"host": {}, "device": {"device_densify": True}, "blocks": {"engine": "blocks"}}
# sync, async, async with the densify worker thread
RUNS = {"sync": {}, "async": {"async_consume": True},
        "thread": {"async_consume": True, "densify_thread": True}}
N = 4  # shards of the sharded cases


def _snap(seed=51):
    sc = build_scenario(ScenarioConfig(seed=seed))
    return encode_snapshot(RCoordinator(sc.registry, sc.dpm))


def _world(seed=51):
    """The reference's coordinator and the port's, at one state."""
    snap = _snap(seed)
    return {"ref": decode_snapshot(snap), "port": coordinator_from_snapshot(snap)}


def _app(side, coord, mode="host", **kwargs):
    E, _ = SIDES[side]
    if side == "port":
        kwargs.setdefault("device", "cpu")
    return E.METLApp(coord, **MODES[mode], **kwargs)


def _evolve(E, reg, which=0, tag="evo"):
    """A SchemaEvolved of the ``which``-th schema: drop its first attribute,
    add ``tag``."""
    o = reg.domain.schema_ids()[which]
    v = reg.domain.latest_version(o)
    keep = tuple(a.name for a in reg.domain.get(o, v).attributes)[1:]
    return E.SchemaEvolved(tree="domain", schema_id=o, keep=keep, add=(tag,))


def _both(build, *, mode="host", seed=51, drive=None, app_kwargs=None, **pipe_kwargs):
    """Run one scenario on both sides: ``build(E, syn, coord, app)`` returns
    (source, sinks); ``drive(pipe, sinks)`` runs the pipeline and returns
    the ``PipelineStats`` of each run (default: one ``run()``).  Returns
    {side: (sinks, app, [stats], pipe)}."""
    out = {}
    for side, coord in _world(seed).items():
        E, syn = SIDES[side]
        app = _app(side, coord, mode, **(app_kwargs or {}))
        source, sinks = build(E, syn, coord, app)
        pipe = E.Pipeline(source, app, sinks, **pipe_kwargs)
        stats = drive(pipe, sinks) if drive is not None else [pipe.run()]
        pipe.close()
        out[side] = (sinks, app, stats, pipe)
    return out


def _assert_same(out, *, sink=-1):
    """Port rows, PipelineStats and app.stats equal the reference's."""
    r, t = out["ref"], out["port"]
    _assert_rows_equal(t[0][sink].rows, r[0][sink].rows)
    assert [dataclasses.asdict(s) for s in t[2]] == [dataclasses.asdict(s) for s in r[2]]
    assert dict(t[1].stats) == dict(r[1].stats)
    return t[0][sink].rows


def _control_stream(E, syn, coord, app, *, n_chunks=6, size=100, at=2):
    """An EventChunkSource with duplicates and one scheduled evolution."""
    src = E.EventSource(coord.registry, seed=2, p_duplicate=0.1)
    ev = _evolve(E, coord.registry)
    return (E.EventChunkSource(src, chunk_size=size, max_chunks=n_chunks, control={at: ev}),
            [E.CollectSink()])


# ---------------------------------------------------------------------------
# every mode: sync, async, densify thread
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_matches_reference(mode, run):
    """Rows, PipelineStats and stats equal the reference's in the same
    mode, across an in-band evolution; each async run equals the sync run
    of its mode, and the fused engines make one dispatch a chunk."""
    out = _both(_control_stream, mode=mode, **RUNS[run])
    rows = _assert_same(out)
    st, app = out["port"][2][0], out["port"][1]
    assert rows and st.chunks == 6 and st.control == 1 and st.events == 600
    if mode != "blocks":
        assert app.stats["dispatches"] == 6
    if run != "sync":
        sync = _both(_control_stream, mode=mode)
        _assert_rows_equal(rows, sync["port"][0][-1].rows)
        assert dict(app.stats) == dict(sync["port"][1].stats)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_pipeline_equals_fused_pipeline(device_densify, run):
    """In this process: the port's sharded pipeline (4 CPU shards) against
    its fused pipeline, which the cases above hold to the reference."""
    snap = _snap()
    rows = []
    for mesh in (None, make_etl_mesh(devices=["cpu"] * N)):
        coord = coordinator_from_snapshot(snap)
        app = T.METLApp(coord, engine="sharded" if mesh else "fused", mesh=mesh,
                        device="cpu", device_densify=device_densify)
        source, sinks = _control_stream(T, tsyn, coord, app)
        pipe = T.Pipeline(source, app, sinks, **RUNS[run])
        st = pipe.run()
        pipe.close()
        assert st.chunks == 6 and st.control == 1
        rows.append((sinks[0].rows, dict(app.stats), app.engine.info()))
    _assert_rows_equal(rows[1][0], rows[0][0])
    assert rows[1][1] == rows[0][1]
    assert rows[1][2]["engine"] == "sharded" and rows[1][2]["n_shards"] == N


def _sharded_parity(device_densify: bool) -> None:
    """Run in a 4-device process: the sharded pipeline, sync, async and
    async with the densify thread, against the reference's sharded
    pipeline on a 4-device CPU mesh."""
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    for run in RUNS:
        out = {}
        for side, coord in _world().items():
            E, syn = SIDES[side]
            mesh = (r_make_etl_mesh(N) if side == "ref"
                    else make_etl_mesh(devices=["cpu"] * N))
            kwargs = {"device": "cpu"} if side == "port" else {}
            app = E.METLApp(coord, engine="sharded", mesh=mesh,
                            device_densify=device_densify, **kwargs)
            source, sinks = _control_stream(E, syn, coord, app)
            pipe = E.Pipeline(source, app, sinks, **RUNS[run])
            n0 = ops.dispatch_count
            st = pipe.run()
            pipe.close()
            out[side] = (sinks, app, [st], pipe)
            if side == "port":
                assert ops.dispatch_count - n0 == app.stats["dispatches"] == 6
                assert app.engine.info()["n_shards"] == N
        assert _assert_same(out)


@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_pipeline_matches_reference(device_densify):
    out = run_sub(f"""
        import sys
        sys.path.insert(0, {str(TESTS)!r})
        import test_torch_pipeline as t
        t._sharded_parity({device_densify})
        print("subprocess OK")
    """)
    assert "subprocess OK" in out


# ---------------------------------------------------------------------------
# in-band control: scripted wrapper, literal list event
# ---------------------------------------------------------------------------


def _scripted(E, syn, coord, app):
    """Any source wrapped: an evolution before its third data chunk."""
    src = E.EventSource(coord.registry, seed=3, p_duplicate=0.0)
    ev = _evolve(E, coord.registry, which=1, tag="scripted")
    inner = E.EventChunkSource(src, chunk_size=80, max_chunks=5)
    return E.ScriptedControlSource(inner, {2: ev}), [E.CollectSink()]


def _literal(E, syn, coord, app):
    """A literal stream: two chunks, an evolution, two chunks made for the
    state the evolution leads to."""
    src = E.EventSource(coord.registry, seed=4, p_duplicate=0.0)
    chunks = [src.slice(k * 60, 60) for k in range(4)]
    for chunk in chunks[2:]:
        for e in chunk:
            e.state += 1
    ev = _evolve(E, coord.registry, which=2, tag="literal")
    return E.ListSource([*chunks[:2], ev, *chunks[2:]]), [E.CollectSink()]


@pytest.mark.parametrize("run", ["sync", "async"])
@pytest.mark.parametrize("how", ["scripted", "literal"])
def test_in_band_control_sources_match_reference(how, run):
    out = _both(_scripted if how == "scripted" else _literal, **RUNS[run])
    rows = _assert_same(out)
    app = out["port"][1]
    assert rows and out["port"][2][0].control == 1 and out["port"][2][0].chunks in (4, 5)
    assert len(app.coordinator.control_log) == 1 and app.stats["evictions"] == 1
    assert app.stats["mapped"] > 0 and app.stats["stale"] == 0


def test_scripted_source_refuses_chunks_and_fires_once():
    coord = _world()["port"]
    src = T.EventSource(coord.registry, seed=3)
    ev = _evolve(T, coord.registry)
    wrapped = T.ScriptedControlSource(T.ListSource([src.slice(0, 10)]), {0: ev})
    with pytest.raises(ValueError, match="in-band control"):
        wrapped.chunks()
    with pytest.raises(ValueError, match="in-band control"):
        T.EventChunkSource(src, control={0: ev}).chunks()
    items = list(wrapped.poll())
    assert items[0] is ev and len(items) == 2
    wrapped.reset_offset(0)
    assert [type(i) for i in wrapped.poll()] == [list]  # control never re-fires
    with pytest.raises(ValueError, match="stride"):
        T.EventChunkSource(src, stride=2, offset=2)


# ---------------------------------------------------------------------------
# parked-event replay
# ---------------------------------------------------------------------------


def _parked_then_later(E, syn, coord, app):
    """Six events from the app's future (parked), the evolution that makes
    them current applied between two runs, then chunks at the new state."""
    src = E.EventSource(coord.registry, seed=12, p_duplicate=0.0)
    parked = src.slice(0, 6)
    for e in parked:
        e.state += 1
    return E.ListSource([parked]), [E.CollectSink()]


@pytest.mark.parametrize("run", list(RUNS))
def test_state_bump_mid_stream_replays_into_sinks(run):
    """A state change between runs evicts the plan; the next chunk's triage
    refreshes lazily and replays the parked events into the sinks."""

    def drive(pipe, sinks):
        E = R if isinstance(pipe, R.Pipeline) else T
        coord = pipe.app.coordinator
        st = [pipe.run()]
        assert sinks[0].rows == [] and pipe.app.stats["parked"] == 6
        coord.apply(_evolve(E, coord.registry))
        src = E.EventSource(coord.registry, seed=12, p_duplicate=0.0)
        pipe.source = E.ListSource([src.slice(50, 40), src.slice(90, 40)])
        st.append(pipe.run())
        return st

    out = _both(_parked_then_later, drive=drive, **RUNS[run])
    _assert_same(out)
    app = out["port"][1]
    assert app.stats["replayed"] == 6
    assert out["port"][2][1].rows == len(out["port"][0][0].rows) > 0


class _EvolvingSink:
    """A sink whose first write applies a schema evolution to the
    coordinator: out of band, so the eviction lands between chunk N's
    emit and the next lookahead's triage, whose lazy refresh then replays
    the parked events (densify, dispatch, emit) inside that triage."""

    def __init__(self, E, coord):
        self.E, self.coord, self.done = E, coord, False
        self.rows = []

    def write(self, rows):
        self.rows.extend(rows)
        if not self.done:
            self.done = True
            self.coord.apply(_evolve(self.E, self.coord.registry, tag="oob"))

    def full(self):
        return False

    def close(self):
        pass


def _refresh_in_lookahead(E, syn, coord, app):
    src = E.EventSource(coord.registry, seed=14, p_duplicate=0.0)
    first = src.slice(0, 60)
    ahead = src.slice(60, 8)
    for e in ahead:  # from the app's future: parked, replayed after the bump
        e.state += 1
    rest = [src.slice(k * 60, 60) for k in range(2, 6)]
    for chunk in rest:  # made for the state the evolution leads to
        for e in chunk:
            e.state += 1
    return E.ListSource([first, ahead, *rest]), [_EvolvingSink(E, coord)]


@pytest.mark.parametrize("run", list(RUNS))
def test_refresh_inside_the_lookahead_matches_reference(run):
    """The sink's evolution evicts between chunk 1's emit and the next
    lookahead.  Async: the parked chunk was triaged ahead, before the
    eviction, so the next lookahead's lazy refresh replays it; sync: the
    chunk is triaged after the refresh and maps directly."""
    out = _both(_refresh_in_lookahead, **RUNS[run])
    rows = _assert_same(out)
    stats = out["port"][1].stats
    parked = 0 if run == "sync" else 8
    assert stats["parked"] == stats["replayed"] == parked and stats["refreshes"] == 2
    assert stats["stale"] == parked and stats["dead_lettered"] == 0 and len(rows) > 100


# ---------------------------------------------------------------------------
# plan lifecycle under the pipeline
# ---------------------------------------------------------------------------


def _churn(E, syn, coord, app):
    """Two evolutions and a MatrixEdit back to the seed DPM, in band."""
    dpm0 = dict(coord.snapshot().dpm)
    ev1 = _evolve(E, coord.registry, 0, "c1")
    ev2 = _evolve(E, coord.registry, 1, "c2")
    src = E.EventSource(coord.registry, seed=5)
    return (E.EventChunkSource(src, chunk_size=64, max_chunks=7,
                               control={1: ev1, 3: ev2, 5: E.MatrixEdit(dpm=dpm0)}),
            [E.CollectSink()])


@pytest.mark.parametrize("run", ["sync", "async"])
@pytest.mark.parametrize("kind", ["fused", "blocks"])
def test_incremental_rows_match_full_rebuild_and_reference(kind, run):
    """test_plan.py's oracle through the port's pipeline: a manager that
    splices only the touched columns gives the rows of one that rebuilds in
    full, and both the reference's incremental app's."""
    results = {}
    for incremental in (True, False):
        out = {}
        for side, coord in _world(91).items():
            E, syn = SIDES[side]
            kw = {"device": "cpu"} if side == "port" else {}
            mgr = E.PlanManager(kind=kind, coordinator=coord, incremental=incremental, **kw)
            app = E.METLApp(coord, engine=kind, plan_manager=mgr)
            source, sinks = _churn(E, syn, coord, app)
            pipe = E.Pipeline(source, app, sinks, **RUNS[run])
            st = pipe.run()
            pipe.close()
            mgr.close()
            assert st.chunks == 7 and st.control == 3
            out[side] = (sinks, app, [st], pipe)
            if side == "port":
                info = mgr.info()
                assert info["rebuilds"] == 4
                assert info["incremental_rebuilds"] == (3 if incremental else 0)
        results[incremental] = _assert_same(out)
    assert results[True]
    _assert_rows_equal(results[True], results[False])


# ---------------------------------------------------------------------------
# tests/test_pipeline.py, case by case
# ---------------------------------------------------------------------------


def _chunks(E, coord, n, size=100, seed=2, p_duplicate=0.1):
    src = E.EventSource(coord.registry, seed=seed, p_duplicate=p_duplicate)
    return [src.slice(k * size, size) for k in range(n)]


def test_sync_pipeline_matches_direct_consume():
    coord = _world()["port"]
    chunks = _chunks(T, coord, 4)
    direct = _app("port", coord)
    rows_direct = [r for c in chunks for r in direct.consume(c)]
    app = _app("port", coord)
    sink = T.CollectSink()
    st = T.Pipeline(T.ListSource(chunks), app, [sink]).run()
    _assert_rows_equal(sink.rows, rows_direct)
    assert st.chunks == 4 and st.events == 400 and st.rows == len(sink.rows)
    assert dict(direct.stats) == dict(app.stats)


def test_fanout_two_sinks_and_table_sink_match_reference():
    def build(E, syn, coord, app):
        return E.ListSource(_chunks(E, coord, 3)), [
            E.TableSink(), E.TokenizerSink(vocab=512, max_len=12), E.CollectSink()]

    out = _both(build, async_consume=True)
    rows = _assert_same(out)
    (r_dw, r_ml, _), (t_dw, t_ml, _) = out["ref"][0], out["port"][0]
    assert t_ml.prompts == r_ml.prompts and len(t_ml.prompts) == len(rows) > 0
    for p in t_ml.prompts:
        assert 1 <= len(p) <= 12 and all(1 <= tok < 512 for tok in p)
    r_tab, t_tab = r_dw.to_arrays(), t_dw.to_arrays()
    assert sorted(t_tab) == sorted(r_tab)
    coord = out["port"][1].coordinator
    for rw, t in t_tab.items():
        assert t["keys"].dtype == np.int64
        assert t["values"].shape == (len(t_dw.tables[rw]), len(coord.registry.range.get(*rw).uids))
        for key in ("keys", "values", "mask"):
            assert t[key].dtype == np.asarray(r_tab[rw][key]).dtype, key
            np.testing.assert_array_equal(t[key], np.asarray(r_tab[rw][key]))


def test_backpressure_full_sink_stops_pull():
    def build(E, syn, coord, app):
        src = E.EventSource(coord.registry, seed=2, p_duplicate=0.1)
        return (E.EventChunkSource(src, chunk_size=100, max_chunks=10),
                [E.TokenizerSink(vocab=512, limit=30)])

    out = _both(build, async_consume=True)
    (r_sink,), (t_sink,) = out["ref"][0], out["port"][0]
    assert t_sink.full() and t_sink.prompts == r_sink.prompts and len(t_sink.prompts) == 30
    assert out["port"][2][0].chunks < 10
    assert dataclasses.asdict(out["port"][2][0]) == dataclasses.asdict(out["ref"][2][0])
    assert out["port"][3]._pending is not None


def _bounded(limit, n=6, tokenizer=True):
    def build(E, syn, coord, app):
        bounded = (E.TokenizerSink(vocab=512, limit=limit) if tokenizer
                   else E.CollectSink(limit=limit))
        return E.ListSource(_chunks(E, coord, n)), [bounded, E.CollectSink()]
    return build


@pytest.mark.parametrize("resume", ["async", "sync"])
def test_lookahead_survives_stop_no_event_loss(resume):
    """A stopped async run keeps one triaged lookahead chunk; a resume,
    async or sync, maps it first: the rows equal an uninterrupted run's."""

    def drive(pipe, sinks):
        st1 = pipe.run()
        assert sinks[0].full() and st1.chunks < 6 and pipe._pending is not None
        sinks[0].limit = None
        pipe.async_consume = resume == "async"
        return [st1, pipe.run()]

    out = _both(_bounded(25), drive=drive, async_consume=True)
    rows = _assert_same(out)
    assert sum(s.chunks for s in out["port"][2]) == 6
    coord = _world()["port"]
    ref_app = _app("port", coord)
    _assert_rows_equal(rows, [r for c in _chunks(T, coord, 6) for r in ref_app.consume(c)])


def test_pending_not_flushed_into_still_full_sink():
    def drive(pipe, sinks):
        st1 = pipe.run()
        assert pipe._pending is not None
        pipe.async_consume = False
        st2 = pipe.run()  # still full: nothing mapped, pending kept
        assert st2.chunks == 0 and pipe._pending is not None
        return [st1, st2]

    _assert_same(_both(_bounded(1, 4, tokenizer=False), drive=drive, async_consume=True),
                 sink=0)


def test_max_chunks_budget_includes_pending():
    def drive(pipe, sinks):
        st1 = pipe.run()  # chunk 1 fanned out, chunk 2 pending
        assert st1.chunks == 1 and pipe._pending is not None
        st_stall = pipe.run(max_chunks=2)  # still full: no pull, no budget burnt
        assert st_stall.chunks == 0 and pipe._pending is not None
        sinks[0].limit = None
        st2 = pipe.run(max_chunks=2)  # pending + ONE fresh pull
        assert st2.chunks == 2
        st3 = pipe.run()
        assert st1.chunks + st2.chunks + st3.chunks == 5
        return [st1, st_stall, st2, st3]

    _assert_same(_both(_bounded(1, 5, tokenizer=False), drive=drive, async_consume=True))


def test_sync_backpressure_never_drops_a_chunk():
    def drive(pipe, sinks):
        st1 = pipe.run()
        assert st1.chunks == 1
        sinks[0].limit = None
        return [st1, pipe.run()]

    out = _both(_bounded(1, 4, tokenizer=False), drive=drive)
    rows = _assert_same(out)
    assert sum(s.chunks for s in out["port"][2]) == 4 and rows


def test_batcher_sink_pulls_until_batch_ready():
    def build(E, syn, coord, app):
        src = E.EventSource(coord.registry, seed=2, p_duplicate=0.1)
        batcher = E.CanonicalBatcher(vocab=512, seq_len=16, batch_size=2)
        return E.EventChunkSource(src, chunk_size=100), [E.BatcherSink(batcher),
                                                         E.CollectSink()]

    def drive(pipe, sinks):
        batches, st = [], []
        batcher = sinks[0].batcher
        for _ in range(3):
            while not batcher.ready():
                st.append(pipe.run())
            batches.append(batcher.next_batch())
        sinks[0].batches = batches
        return st

    out = _both(build, drive=drive, async_consume=True)
    _assert_same(out)
    assert len(out["port"][0][0].batches) == 3
    for r, t in zip(out["ref"][0][0].batches, out["port"][0][0].batches):
        assert t["tokens"].shape == (2, 16)
        assert (t["labels"][:, :-1] == t["tokens"][:, 1:]).all()
        for key in ("tokens", "labels", "loss_weight"):
            assert t[key].dtype == r[key].dtype
            np.testing.assert_array_equal(t[key], r[key])


def test_consume_scalar_lazy_refresh_buffers_replay():
    coord = _world()["port"]
    app = _app("port", coord)
    evs = T.EventSource(coord.registry, seed=13, p_duplicate=0.0).slice(0, 5)
    for e in evs:
        e.state += 1
    app.consume(evs)
    assert app.stats["parked"] == 5
    coord.apply(_evolve(T, coord.registry))
    want = _app("port", coord).consume_scalar(evs)
    app.consume_scalar([])  # the lazy refresh + replay
    assert app.stats["replayed"] == 5 and len(app.take_replayed()) == len(want) > 0


def test_event_chunk_source_cursor_persists():
    coord = _world()["port"]
    source = T.EventChunkSource(T.EventSource(coord.registry, seed=2), chunk_size=64,
                                max_chunks=4)
    first = list(source.chunks())
    assert len(first) == 4 and first[1].keys[0] != first[0].keys[0]
    assert list(source.chunks()) == []  # lifetime bound reached
    assert source.next_index == 4


@pytest.mark.parametrize("run", ["sync", "async"])
def test_empty_source(run):
    app = _app("port", _world()["port"])
    st = T.Pipeline(T.ListSource([]), app, [T.CollectSink()], **RUNS[run]).run()
    assert st.chunks == 0 and st.rows == 0


# ---------------------------------------------------------------------------
# tests/test_columnar.py's pipeline cases: Source.reset_offset
# ---------------------------------------------------------------------------


def test_list_source_finished_cursor_resets():
    coord = _world()["port"]
    src = T.EventSource(coord.registry, seed=9)
    chunks = [src.slice_columnar(k * 40, 40) for k in range(3)]
    source = T.ListSource(chunks)
    assert len(list(source.chunks())) == 3 and list(source.chunks()) == []
    source.reset_offset(45)  # inside chunk 1
    assert list(source.chunks()) == chunks[1:]  # the same chunk objects
    source.reset_offset(10_000)
    assert list(source.chunks()) == []
    legacy = T.ListSource([src.slice(0, 40), src.slice(40, 40)])
    list(legacy.chunks())
    legacy.reset_offset(0)
    assert len(list(legacy.chunks())) == 2


def test_event_chunk_source_reset_offset_realigns_grid():
    worlds = _world()
    keys = {}
    for side, coord in worlds.items():
        E, _ = SIDES[side]
        source = E.EventChunkSource(E.EventSource(coord.registry, seed=10), chunk_size=32,
                                    max_chunks=3)
        first = list(source.chunks())
        assert len(first) == 3 and list(source.chunks()) == []
        source.reset_offset(40)  # inside the second slice: aligns to 32
        again = list(source.chunks())
        assert len(again) == 2  # the budget re-aimed, not burnt
        assert [e.key for e in again[0]] == [e.key for e in first[1]]
        keys[side] = [[e.key for e in c] for c in first + again]
    assert keys["port"] == keys["ref"]


def test_dead_letter_replay_through_source_reset():
    """Outdated events dead-letter; METLApp.reset_offset names the rewind
    position; the source re-slices at the current state and they map, as
    in the reference."""

    def build(E, syn, coord, app):
        src = E.EventSource(coord.registry, seed=11, p_duplicate=0.0)
        stale = src.slice(64, 32)  # made at the current state ...
        coord.registry.bump_state()  # ... which the registry then leaves behind
        app.refresh()
        assert app.consume(stale) == [] and app.stats["dead_lettered"] == 32
        pos = app.reset_offset()
        assert pos == 64
        source = E.EventChunkSource(src, chunk_size=32, columnar=True)
        source.reset_offset(pos)
        return source, [E.CollectSink()]

    out = _both(build, seed=62, drive=lambda pipe, sinks: [pipe.run(max_chunks=1)])
    rows = _assert_same(out)
    st = out["port"][2][0]
    assert st.chunks == 1 and st.events == 32 and rows
    assert out["port"][1].stats["duplicates"] == 0


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def test_tokenize_row_and_canonical_batcher_match_reference():
    out = _both(_control_stream)
    r_rows, t_rows = out["ref"][0][0].rows, out["port"][0][0].rows
    assert len(t_rows) > 100
    for vocab in (3, 512, 50_304):
        assert ([T.batcher.tokenize_row(r, vocab) for r in t_rows]
                == [R.batcher.tokenize_row(r, vocab) for r in r_rows])
    assert T.batcher.BOS == R.batcher.BOS and T.batcher.VALUE_BUCKETS == R.batcher.VALUE_BUCKETS
    empty = (((0, 1), np.zeros(4, np.float32), np.zeros(4, np.int8), 7))
    assert T.batcher.tokenize_row(empty, 512) == [T.batcher.BOS]
    tb = T.CanonicalBatcher(vocab=512, seq_len=8, batch_size=3)
    rb = R.CanonicalBatcher(vocab=512, seq_len=8, batch_size=3)
    with pytest.raises(ValueError, match="not enough"):
        tb.next_batch()
    tb.add_rows(t_rows)
    rb.add_rows(r_rows)
    n = 0
    while rb.ready():
        assert tb.ready()
        want, got = rb.next_batch(), tb.next_batch()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        n += 1
    assert n > 2 and not tb.ready()


@pytest.mark.parametrize("arch", ["olmo_1b", "whisper_tiny", "internvl2_1b"])
def test_make_token_batch_matches_reference(arch):
    """Dense, audio (frames) and VLM (patches) families."""
    rcfg, tcfg = RC.get_smoke(arch), TC.get_smoke(arch)
    for kw in ({}, dict(step=3, shard=1, state=2, seed=5)):
        want = R.make_token_batch(rcfg, 2, 8, **kw)
        got = T.make_token_batch(tcfg, 2, 8, **kw)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# the double buffer and the engines' two host arenas
# ---------------------------------------------------------------------------


class _GuardedArenas(tengines._HostArenas):
    """The engines' arenas, counting ``take``s and failing on the rewrite of
    an arena whose chunk was densified and not yet dispatched."""

    def __init__(self, device):
        super().__init__(device)
        self.takes = 0
        self.live = [False, False]  # taken by a densify, not yet dispatched

    def take(self, n_bytes):
        if self.live[self.next]:
            raise AssertionError(f"densify took arena {self.next}, whose chunk was "
                                 "never dispatched")
        slot, turn, buf = super().take(n_bytes)
        self.takes += 1
        self.live[slot] = True
        return slot, turn, buf

    def release(self, slot):
        self.live[slot] = False
        super().release(slot)


def _guard(app):
    guard = _GuardedArenas(app.engine.device)
    app.engine._arenas = guard
    return guard


def _arena_case(case):
    """(build, drive, pipeline keywords) of each edge case."""
    if case == "control drain":
        return _control_stream, None, {}
    if case == "refresh in lookahead":
        return _refresh_in_lookahead, None, {}

    def drive(pipe, sinks):
        st1 = pipe.run()
        assert pipe._pending is not None
        sinks[0].limit = None
        pipe.async_consume = case == "pending, async resume"
        return [st1, pipe.run()]

    return _bounded(1, 5, tokenizer=False), drive, {}


ARENA_CASES = ["pending, async resume", "pending, sync resume", "refresh in lookahead",
               "control drain"]


@pytest.mark.parametrize("densify_thread", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", ARENA_CASES)
def test_double_buffer_never_reuses_a_live_arena(case, mode, densify_thread):
    """The backpressured ``_pending`` chunk flushed by an async or a sync
    resume, a lazy refresh whose replay runs consume inside the lookahead's
    triage, and a control-boundary drain: no densify takes the arena of an
    undispatched chunk, every taken arena is dispatched, and the rows equal
    the reference's."""
    build, drive, _ = _arena_case(case)
    guards = []

    def guarded(E, syn, coord, app):
        if E is T:
            guards.append(_guard(app))
        return build(E, syn, coord, app)

    out = _both(guarded, mode=mode, drive=drive, async_consume=True,
                densify_thread=densify_thread)
    rows = _assert_same(out, sink=-1)
    guard, app = guards[0], out["port"][1]
    assert rows and guard.takes > 0 and guard.live == [False, False]
    # one take a densified chunk: a fused chunk is one dispatch, a per-block
    # chunk one launcher call (every chunk here maps)
    if mode != "blocks":
        assert guard.takes == app.stats["dispatches"]
