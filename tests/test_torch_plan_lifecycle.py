"""The port's plan lifecycle against the reference's, on the CPU.

Incremental recompaction, residency tiering, the background build and
``PlanPublished`` epochs.  Both sides start from one state (carried across
with ``coordinator_from_snapshot(encode_snapshot(coord))``) and apply the
same control events with ``coord.apply`` between ``consume`` calls.

Covered: ``recompile_columns`` against ``compile_dpm``, and ``splice_fused``
against ``compile_fused`` / ``compile_fused_sharded`` (1, 3 and 4 shards) and
against the reference's spliced tables, byte for byte, after every step of a
churn that widens the table, shrinks it again and ends with a
``MatrixEdit`` back to the seed DPM; incremental consume rows and ``stats``
against full rebuilds and the reference's incremental app (fused host and
device densify; sharded with the reference in a 4-device subprocess); the
all-cold fallback and ``repartition`` against the reference's tiered app;
the background build against the synchronous one; the ``PlanPublished``
log and its replay; ``consume_scalar``, ``state`` and ``engine_name``; and
the soak of ``benchmarks/bench_compaction.py`` at its smoke size, gated as
``chip_smoke.py`` gates it at full size.  On the CPU a cold block maps
through ``masked_gather``'s plain version; the ``gpu`` test holds the
kernel's cold rows against the CPU run's.
"""

import dataclasses
import functools
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dmm_jax as rdmm
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario, churn_schedule, soak_config
from repro.etl import EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl import PlanManager as RPlanManager
from repro.etl import TieringPolicy as RTieringPolicy
from repro.etl import control as rcontrol
from repro.etl.transport import decode_snapshot, encode_snapshot

from repro_torch.core import dmm_torch as tdmm
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.core.state import StateCoordinator as TCoordinator
from repro_torch.core.synthetic import build_scenario as t_build_scenario
from repro_torch.core.synthetic import soak_config as t_soak_config
from repro_torch.etl import (
    METLApp,
    PlanManager,
    PlanPublished,
    ShardedEngine,
    TieringPolicy,
    make_engine,
    replay_control_log,
)
from repro_torch.etl import control as tcontrol
from repro_torch.etl.events import EventSource as TEventSource
from repro_torch.kernels import masked_gather, ops
from repro_torch.launch.mesh import make_etl_mesh

from _subproc import run_sub as _run_sub
from test_torch_metl import (  # noqa: F401  (hopper: the card fixture)
    _assert_rows_equal, _port_events, hopper,
)

run_sub = functools.partial(_run_sub, devices=4)
TESTS = Path(__file__).resolve().parent
N = 4  # shards of the sharded cases
CFG = ScenarioConfig(n_schemas=5, versions_per_schema=3, attrs_per_version=6,
                     n_entities=2, cdm_attrs=8, seed=31)
WIDE = 140  # attributes of the entity that widens the table past one lane


def _worlds(cfg=CFG):
    """The reference's coordinator and the port's, at one state."""
    sc = build_scenario(cfg)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    return decode_snapshot(snap), coordinator_from_snapshot(snap)


def _port_event(ev):
    """The port's twin of a reference control event."""
    fields = {f.name: getattr(ev, f.name) for f in dataclasses.fields(ev)}
    return getattr(tcontrol, type(ev).__name__)(**fields)


def _apply(r_coord, t_coord, ev):
    r_coord.apply(ev)
    t_coord.apply(_port_event(ev))
    assert t_coord.registry.state == r_coord.registry.state


def _touched(old_dpm, new_dpm):
    touched = {(k[0], k[1]) for k in set(old_dpm) ^ set(new_dpm)}
    for k in set(old_dpm) & set(new_dpm):
        if old_dpm[k] != new_dpm[k]:
            touched.add((k[0], k[1]))
    return touched


def _churn_script(r_coord):
    """Three schema evolutions (``churn_schedule``) and a wide CDM entity;
    :func:`_script_events` adds the matrix edits.  Built against the
    reference coordinator, which must be at the seed state."""
    dpm0 = dict(r_coord.snapshot().dpm)
    script = [ev for _, ev in sorted(churn_schedule(r_coord.registry, steps=3, seed=3).items())]
    wide_id = max(r_coord.registry.range.schema_ids()) + 1
    script.append(rcontrol.SchemaAdded(tree="range", schema_id=wide_id,
                                       names=tuple(f"wide.c{k}" for k in range(WIDE))))
    return dpm0, wide_id, script


def _widen(registry, dpm0, wide_id):
    """``dpm0`` plus one block mapping the first column's attributes into
    the wide entity."""
    o, v = sorted({(k[0], k[1]) for k in dpm0})[0]
    in_uids = registry.domain.get(o, v).uids
    out_uids = registry.range.get(wide_id, 1).uids
    block = frozenset((out_uids[3 * k], p) for k, p in enumerate(in_uids))
    return {**dpm0, (o, v, wide_id, 1): block}


def _steps(r_coord, t_coord):
    """Apply the churn script to both coordinators, yielding after each
    step (the reference's DPM before and after it)."""
    for ev in _script_events(r_coord):
        old = dict(r_coord.snapshot().dpm)
        _apply(r_coord, t_coord, ev)
        yield old, dict(r_coord.snapshot().dpm)


def _script_events(r_coord):
    """The churn script's events, each made just before it is applied (the
    widening edit needs the wide entity in the registry): the script, a
    ``MatrixEdit`` giving one column a block of the wide entity (the table
    widens to two lanes), one that drops an element of another column's
    block (same key, new elements), then one back to the seed DPM (the
    table narrows again while every other column's rows are reused)."""
    dpm0, wide_id, script = _churn_script(r_coord)
    yield from script
    wide = _widen(r_coord.registry, dpm0, wide_id)
    yield rcontrol.MatrixEdit(dpm=wide)
    key = sorted(k for k in dpm0 if len(dpm0[k]) > 1)[-1]
    yield rcontrol.MatrixEdit(dpm={**wide, key: frozenset(sorted(dpm0[key])[1:])})
    yield rcontrol.MatrixEdit(dpm=dpm0)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _assert_compiled_equal(t, r):
    assert t.state == r.state
    assert list(t.by_column) == list(r.by_column)
    for ov, blocks in r.by_column.items():
        for tb, rb in zip(t.by_column[ov], blocks, strict=True):
            assert (tb.key, tb.n_in, tb.n_out) == (rb.key, rb.n_in, rb.n_out)
            _assert_exact(tb.src, rb.src)


def _table(plan) -> np.ndarray:
    if isinstance(plan, tdmm.ShardedFusedDMM):
        return np.concatenate([t.numpy() for t in plan.src3d])
    if isinstance(plan, tdmm.FusedDMM):
        return plan.src2d.numpy()
    return np.asarray(plan.src3d if hasattr(plan, "src3d") else plan.src2d)


def _assert_plans_equal(t, r):
    """Every table and every field of two plans equal, byte for byte (the
    port's against the port's or the reference's)."""
    assert t.state == r.state
    assert (t.n_blocks, t.width, t.n_in_pad) == (r.n_blocks, r.width, r.n_in_pad)
    assert t.routes == r.routes
    _assert_exact(_table(t), _table(r))
    for name in ("n_out", "uid_slot", "uid_col", "col_block_start", "col_block_count"):
        _assert_exact(getattr(t, name), getattr(r, name))
    if hasattr(r, "n_shards"):
        assert (t.n_shards, t.blocks_per_shard) == (r.n_shards, r.blocks_per_shard)
    assert list(t.columns) == list(r.columns)
    for ov, rc in r.columns.items():
        tc = t.columns[ov]
        assert (tc.o, tc.v, tc.n_in, tc.col_id, tc.uid_pos) == (
            rc.o, rc.v, rc.n_in, rc.col_id, rc.uid_pos)
        _assert_exact(tc.block_ids, rc.block_ids)


def _sorted_rows(rows):
    # (event key, route) names a row: an event maps through one column, and
    # a column's block keys are unique
    return sorted(rows, key=lambda r: (r[3], r[0]))


# ---------------------------------------------------------------------------
# the incremental lowering, table by table
# ---------------------------------------------------------------------------


def test_recompile_columns_equals_compile_dpm_and_the_reference():
    r_coord, t_coord = _worlds()
    t_compiled = tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry)
    r_compiled = rdmm.compile_dpm(r_coord.snapshot().dpm, r_coord.registry)
    n = 0
    for old, new in _steps(r_coord, t_coord):
        touched = _touched(old, new)
        t_compiled = tdmm.recompile_columns(t_compiled, t_coord.snapshot().dpm,
                                            t_coord.registry, touched)
        r_compiled = rdmm.recompile_columns(r_compiled, new, r_coord.registry, touched)
        _assert_compiled_equal(
            t_compiled, tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry))
        _assert_compiled_equal(t_compiled, r_compiled)
        n += 1
    assert n == 7


@pytest.mark.parametrize("n_shards", [0, 1, 3, 4])  # 0: the replicated table
def test_splice_equals_full_build_and_the_reference(n_shards):
    """After every churn step the spliced table equals the port's full build
    and the reference's splice, byte for byte, through a width that grows to
    two lanes and shrinks back."""
    r_coord, t_coord = _worlds()

    def build(mod, compiled, registry, **kw):
        if n_shards:
            return mod.compile_fused_sharded(compiled, registry, n_shards=n_shards, **kw)
        return mod.compile_fused(compiled, registry, **kw)

    t_compiled = tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry)
    r_compiled = rdmm.compile_dpm(r_coord.snapshot().dpm, r_coord.registry)
    t_plan = build(tdmm, t_compiled, t_coord.registry, device="cpu")
    r_plan = build(rdmm, r_compiled, r_coord.registry)
    widths = [t_plan.width]
    for old, new in _steps(r_coord, t_coord):
        touched = _touched(old, new)
        t_compiled = tdmm.recompile_columns(t_compiled, t_coord.snapshot().dpm,
                                            t_coord.registry, touched)
        r_compiled = rdmm.recompile_columns(r_compiled, new, r_coord.registry, touched)
        t_plan = tdmm.splice_fused(t_plan, t_compiled, t_coord.registry, touched)
        r_plan = rdmm.splice_fused(r_plan, r_compiled, r_coord.registry, touched)
        _assert_plans_equal(t_plan, build(tdmm, t_compiled, t_coord.registry, device="cpu"))
        _assert_plans_equal(t_plan, r_plan)
        # the host copy the next splice reads: the replicated table, in
        # global block order, for either kind
        _assert_exact(t_plan.table_host, rdmm.compile_fused(r_compiled, r_coord.registry).src2d)
        widths.append(t_plan.width)
    assert widths == [128] * 5 + [256, 256, 128]  # grown, then shrunk with reused rows
    if n_shards:
        assert isinstance(t_plan, tdmm.ShardedFusedDMM) and t_plan.n_shards == n_shards
        assert t_plan.groups == ((torch.device("cpu"), 0, n_shards),)


def test_splice_keeps_the_old_plan_intact():
    """A chunk in flight pins the old plan: the splice copies from its host
    table and leaves its device table as it was."""
    r_coord, t_coord = _worlds()
    compiled = tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry)
    plan = tdmm.compile_fused(compiled, t_coord.registry, device="cpu")
    before = plan.src2d.clone()
    old, new = next(_steps(r_coord, t_coord))
    touched = _touched(old, new)
    compiled = tdmm.recompile_columns(compiled, t_coord.snapshot().dpm, t_coord.registry,
                                      touched)
    spliced = tdmm.splice_fused(plan, compiled, t_coord.registry, touched)
    assert spliced.src2d.data_ptr() != plan.src2d.data_ptr()
    assert torch.equal(plan.src2d, before)
    assert all(c.uids_arr is not None for c in spliced.columns.values())


# ---------------------------------------------------------------------------
# the manager: caching, epochs, incremental by default
# ---------------------------------------------------------------------------


def test_manager_is_incremental_by_default_and_counts_epochs():
    r_coord, t_coord = _worlds()
    mgr = PlanManager(device="cpu")
    l1 = mgr.acquire(t_coord.snapshot(), t_coord.registry)
    assert l1.epoch == 1 and not l1.incremental and l1.cold == {}
    assert mgr.acquire(t_coord.snapshot(), t_coord.registry) is l1
    steps = _steps(r_coord, t_coord)
    next(steps)
    l2 = mgr.acquire(t_coord.snapshot(), t_coord.registry)
    assert l2.epoch == 2 and l2.incremental
    assert 1 <= l2.touched_columns < len(l2.compiled.by_column)
    info = mgr.info()
    assert info == {"plan_epoch": 2, "rebuilds": 2, "incremental_rebuilds": 1,
                    "last_rebuild_s": l2.rebuild_s,
                    "total_rebuild_s": l1.rebuild_s + l2.rebuild_s,
                    "bytes_resident": l2.bytes_resident, "cold_columns": 0}
    mgr.invalidate()
    l3 = mgr.acquire(t_coord.snapshot(), t_coord.registry)
    assert l3.epoch == 3 and not l3.incremental
    _assert_plans_equal(l3.plan, l2.plan)
    assert not PlanManager(device="cpu", incremental=False).incremental


@pytest.mark.parametrize("kind", ["fused", "sharded", "blocks"])
def test_manager_plans_equal_the_full_build_after_every_step(kind):
    r_coord, t_coord = _worlds()
    mesh = make_etl_mesh(devices=["cpu"] * N) if kind == "sharded" else None
    inc = PlanManager(kind=kind, device="cpu", mesh=mesh)
    full = PlanManager(kind=kind, device="cpu", mesh=mesh, incremental=False)
    for mgr in (inc, full):
        mgr.acquire(t_coord.snapshot(), t_coord.registry)
    for _ in _steps(r_coord, t_coord):
        a = inc.acquire(t_coord.snapshot(), t_coord.registry)
        b = full.acquire(t_coord.snapshot(), t_coord.registry)
        assert a.incremental and not b.incremental
        _assert_compiled_equal(a.compiled, b.compiled)
        if kind == "blocks":
            assert torch.equal(a.plan.src_flat, b.plan.src_flat)
        else:
            _assert_plans_equal(a.plan, b.plan)
        assert a.bytes_resident == b.bytes_resident
    assert inc.info()["incremental_rebuilds"] == 7 and full.info()["incremental_rebuilds"] == 0


def test_manager_and_engine_refusals():
    r_coord, t_coord = _worlds()
    with pytest.raises(ValueError, match="needs a coordinator"):
        PlanManager(device="cpu", background=True)
    with pytest.raises(ValueError, match="unknown plan kind"):
        PlanManager(kind="warp", device="cpu")
    with pytest.raises(ValueError, match="consumes plan kind"):
        METLApp(t_coord, plan_manager=PlanManager(kind="blocks", device="cpu"))
    mgr = PlanManager(device="cpu")
    with pytest.raises(ValueError, match="engine runs on"):
        METLApp(t_coord, device="meta", plan_manager=mgr)
    eng = make_engine("fused", device="cpu")
    with pytest.raises(ValueError, match="conflicts with the engine instance's manager"):
        make_engine(eng, manager=mgr)
    assert make_engine(eng, manager=eng.manager) is eng
    # with no device given the app runs on the manager's
    app = METLApp(t_coord, plan_manager=mgr)
    assert app.engine.manager is mgr and app.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# end to end: incremental rows and stats against full rebuilds and the reference
# ---------------------------------------------------------------------------


def _churn_consume(r_app, t_apps, n_chunks=8, size=48, seed=5):
    """Consume a stream through the reference app and the port's apps, with
    the churn script's steps applied between chunks (one step a chunk from
    chunk 1); returns each app's rows."""
    r_coord, t_coords = r_app.coordinator, [a.coordinator for a in t_apps]
    script = _script_events(r_coord)
    src = REventSource(r_coord.registry, seed=seed, p_duplicate=0.1, p_stale=0.05)
    r_rows, t_rows = [], [[] for _ in t_apps]
    for k in range(n_chunks):
        ev = next(script, None) if k else None
        if ev is not None:
            r_coord.apply(ev)
            for c in t_coords:
                c.apply(_port_event(ev))
        events = list(src.slice(k * size, size))
        r_rows += r_app.consume(events)
        for rows, app in zip(t_rows, t_apps):
            rows += app.consume(_port_events(events))
    return r_rows, t_rows


def _port_apps(snap, n=2, **kwargs):
    """The port's incremental app and its full-rebuild twin."""
    apps = []
    for incremental in (True, False)[:n]:
        coord = coordinator_from_snapshot(snap)
        kind = "sharded" if "mesh" in kwargs else "fused"
        mgr = PlanManager(kind=kind, device="cpu", mesh=kwargs.get("mesh"),
                          coordinator=coord, incremental=incremental)
        apps.append(METLApp(coord, plan_manager=mgr, **kwargs))
    return apps


@pytest.mark.parametrize("device_densify", [False, True])
def test_incremental_consume_equals_full_rebuild_and_the_reference(device_densify):
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_coord = decode_snapshot(snap)
    r_app = RMETLApp(r_coord, device_densify=device_densify,
                     plan_manager=RPlanManager(kind="fused", coordinator=r_coord,
                                               incremental=True))
    inc, full = _port_apps(snap, device_densify=device_densify)
    r_rows, (inc_rows, full_rows) = _churn_consume(r_app, [inc, full])
    assert len(r_rows) > 0
    _assert_rows_equal(inc_rows, r_rows)
    _assert_rows_equal(full_rows, r_rows)
    assert dict(inc.stats) == dict(full.stats) == dict(r_app.stats)
    r_info, t_info = r_app.engine.manager.info(), inc.engine.manager.info()
    for key in ("plan_epoch", "rebuilds", "incremental_rebuilds", "bytes_resident",
                "cold_columns"):
        assert t_info[key] == r_info[key], key
    assert t_info["incremental_rebuilds"] == 7
    assert full.engine.manager.info()["incremental_rebuilds"] == 0


def _sharded_churn_parity(device_densify: bool) -> None:
    """Run in a 4-device process: the churn stream through the reference's
    incremental sharded app and the port's incremental and full ones."""
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_coord = decode_snapshot(snap)
    r_mesh = r_make_etl_mesh(N)
    r_app = RMETLApp(r_coord, engine="sharded", mesh=r_mesh, device_densify=device_densify,
                     plan_manager=RPlanManager(kind="sharded", mesh=r_mesh,
                                               coordinator=r_coord))
    inc, full = _port_apps(snap, engine="sharded", mesh=make_etl_mesh(devices=["cpu"] * N),
                           device_densify=device_densify)
    assert isinstance(inc.engine, ShardedEngine)
    r_rows, (inc_rows, full_rows) = _churn_consume(r_app, [inc, full])
    assert len(r_rows) > 0
    _assert_rows_equal(inc_rows, r_rows)
    _assert_rows_equal(full_rows, r_rows)
    assert dict(inc.stats) == dict(full.stats) == dict(r_app.stats)
    assert inc.engine.manager.info()["incremental_rebuilds"] == 7
    assert r_app.engine.manager.info()["incremental_rebuilds"] == 7
    _assert_exact(_table(inc.engine.plan), np.asarray(r_app.engine.plan.src3d))
    r_info, t_info = r_app.engine.info(), inc.engine.info()
    for key in ("n_blocks", "blocks_per_shard", "width", "table_bytes",
                "table_bytes_per_shard", "bytes_resident", "plan_epoch", "rebuilds"):
        assert t_info[key] == r_info[key], key


@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_incremental_consume_equals_the_reference(device_densify):
    out = run_sub(f"""
        import sys
        sys.path.insert(0, {str(TESTS)!r})
        import test_torch_plan_lifecycle as t
        t._sharded_churn_parity({device_densify})
        print("subprocess OK")
    """)
    assert "subprocess OK" in out


# ---------------------------------------------------------------------------
# hot/cold residency tiering
# ---------------------------------------------------------------------------


def _tiered_pair(seed, policy, **app_kwargs):
    """The reference's tiered app and the port's, one state, one policy."""
    sc = build_scenario(ScenarioConfig(seed=seed))
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_coord, t_coord = decode_snapshot(snap), coordinator_from_snapshot(snap)
    r_mgr = RPlanManager(kind="fused", coordinator=r_coord,
                         tiering=RTieringPolicy(**dataclasses.asdict(policy)))
    t_mgr = PlanManager(device="cpu", coordinator=t_coord, tiering=policy)
    return (RMETLApp(r_coord, plan_manager=r_mgr, **app_kwargs),
            METLApp(t_coord, plan_manager=t_mgr, **app_kwargs))


TIER_KEYS = ("tier_misses", "transfers", "dispatches", "mapped", "empty", "unknown_uid")


def test_tiering_policy_equals_the_reference():
    r_coord, t_coord = _worlds()
    ev = churn_schedule(r_coord.registry, steps=1, first_chunk=0, seed=1)[0]
    _apply(r_coord, t_coord, ev)
    r_compiled = rdmm.compile_dpm(r_coord.snapshot().dpm, r_coord.registry)
    t_compiled = tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry)
    hits = {ov: k for k, ov in enumerate(t_compiled.by_column)}
    for min_hits, pin in ((1, True), (1, False), (3, True), (10**9, False)):
        got = TieringPolicy(min_hits, pin).cold_columns(t_compiled, t_coord.registry, hits)
        want = RTieringPolicy(min_hits, pin).cold_columns(r_compiled, r_coord.registry, hits)
        assert got == want


@pytest.mark.parametrize("device_densify", [False, True])
def test_all_cold_fallback_equals_the_reference(device_densify):
    """Every column cold: rows equal the reference's tiered app's in order
    and the untiered app's by key; no dispatch; only the resident table
    counts as resident."""
    policy = TieringPolicy(min_hits=10**9, pin_latest=False)
    r_app, t_app = _tiered_pair(98, policy, device_densify=device_densify)
    plain = METLApp(coordinator_from_snapshot(encode_snapshot(r_app.coordinator)),
                    device="cpu")
    src = REventSource(r_app.coordinator.registry, seed=5)
    n_launch = ops.dispatch_count
    for k in range(3):
        events = src.slice(k * 64, 64)
        want = r_app.consume(events)
        got = t_app.consume(_port_events(events))
        _assert_rows_equal(got, want)
        _assert_rows_equal(_sorted_rows(got), _sorted_rows(plain.consume(_port_events(events))))
    for key in TIER_KEYS:
        assert t_app.stats[key] == r_app.stats[key], key
    assert dict(t_app.stats) == dict(r_app.stats)
    assert t_app.stats["tier_misses"] > 0 and t_app.stats["dispatches"] == 0
    assert t_app.stats["mapped"] == plain.stats["mapped"] > 0
    # every cold block went through ops.dmm_apply, and the stats count none
    lease = t_app.engine.lease
    assert ops.dispatch_count - n_launch > 0
    info = t_app.engine.info()
    assert info["bytes_resident"] == lease.plan.src2d.nbytes < plain.engine.info()["bytes_resident"]
    assert info["bytes_resident"] == r_app.engine.info()["bytes_resident"]
    assert t_app.engine.manager.info()["cold_columns"] == len(lease.compiled.by_column)
    col = next(iter(lease.cold.values()))
    assert all(b.src.base is col.src_flat for b in col.blocks)  # views of one host array


@pytest.mark.parametrize("device_densify", [False, True])
def test_repartition_warms_hit_columns_as_the_reference(device_densify):
    """Hits fed by triage, then a repartition: a new epoch at the same state
    brings the hit columns into the table, as the reference's does; the
    chunks before it map cold only, those after it resident and cold."""
    policy = TieringPolicy(min_hits=1, pin_latest=False)
    r_app, t_app = _tiered_pair(99, policy, device_densify=device_densify)
    plain = METLApp(coordinator_from_snapshot(encode_snapshot(r_app.coordinator)),
                    device="cpu")
    src = REventSource(r_app.coordinator.registry, seed=5)
    lease0 = t_app.engine.lease
    assert lease0.epoch == 1 and lease0.cold
    for sl in ((0, 96), (96, 96)):
        events = src.slice(*sl)
        got = t_app.consume(_port_events(events))
        _assert_rows_equal(got, r_app.consume(events))
        _assert_rows_equal(_sorted_rows(got), _sorted_rows(plain.consume(_port_events(events))))
        if sl[0] == 0:
            assert t_app.stats["tier_misses"] > 0 and t_app.stats["dispatches"] == 0
            t_coord, r_coord = t_app.coordinator, r_app.coordinator
            lease1 = t_app.engine.manager.repartition(t_coord.snapshot(), t_coord.registry)
            r_lease1 = r_app.engine.manager.repartition(r_coord.snapshot(), r_coord.registry)
            assert lease1.epoch == 2 and lease1.state == lease0.state
            assert sorted(lease1.cold) == sorted(r_lease1.cold)
            assert len(lease1.cold) < len(lease0.cold)
            assert lease1.bytes_resident == r_lease1.bytes_resident > lease0.bytes_resident
            _assert_plans_equal(lease1.plan, r_lease1.plan)
            t_app.refresh()
            r_app.refresh()
            assert t_app.engine.lease is lease1
    assert t_app.stats["dispatches"] >= 1 and t_app.stats["tier_misses"] > 0
    assert dict(t_app.stats) == dict(r_app.stats)


@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_tiered_consume_equals_fused_tiered(device_densify):
    """The sharded engine carries cold columns as the fused engine does
    (the fused tiered app is held to the reference above): rows and
    ``stats`` equal, chunk by chunk, with resident and cold columns."""
    sc = build_scenario(ScenarioConfig(seed=97))
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    apps = []
    for mesh in (None, make_etl_mesh(devices=["cpu"] * N)):
        coord = coordinator_from_snapshot(snap)
        mgr = PlanManager(kind="fused" if mesh is None else "sharded", device="cpu",
                          mesh=mesh, coordinator=coord,
                          tiering=TieringPolicy(min_hits=10**9, pin_latest=True))
        apps.append(METLApp(coord, engine="sharded", mesh=mesh, device="cpu",
                            plan_manager=mgr, device_densify=device_densify))
    fused, sharded = apps
    assert isinstance(sharded.engine, ShardedEngine)
    src = REventSource(sc.registry, seed=5)
    for k in range(3):
        events = _port_events(src.slice(k * 96, 96))
        _assert_rows_equal(sharded.consume(events), fused.consume(events))
    assert dict(sharded.stats) == dict(fused.stats)
    assert sharded.stats["tier_misses"] > 0 and sharded.stats["dispatches"] == 3
    assert sharded.engine.manager.info()["cold_columns"] > 0


def test_record_hits_takes_counts_and_triage_feeds_it():
    r_coord, t_coord = _worlds()
    mgr = PlanManager(device="cpu", tiering=TieringPolicy())
    mgr.record_hits([((0, 1), 3), ((0, 1), 0), ((1, 1), 2)])
    mgr.record_hits({(1, 1): np.arange(4)})
    assert mgr._hits == {(0, 1): 3, (1, 1): 6}
    app = METLApp(t_coord, plan_manager=mgr)
    tri = app.triage(TEventSource(t_coord.registry, seed=5, p_duplicate=0.0).slice(0, 40))
    for ov, idx in tri.by_column.items():
        assert mgr._hits[ov] >= idx.size


# ---------------------------------------------------------------------------
# the background build and PlanPublished
# ---------------------------------------------------------------------------


def _published_run(snap, **mgr_kwargs):
    """The churn stream through one port app whose manager is bound to its
    coordinator; returns (rows, app)."""
    t_coord = coordinator_from_snapshot(snap)
    mgr = PlanManager(device="cpu", coordinator=t_coord, **mgr_kwargs)
    app = METLApp(t_coord, plan_manager=mgr)
    r_app = RMETLApp(decode_snapshot(snap))
    try:
        _, (rows,) = _churn_consume(r_app, [app])
    finally:
        mgr.close()
    return rows, app


def test_background_build_equals_the_sync_build():
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    rows_sync, app_sync = _published_run(snap)
    rows_bg, app_bg = _published_run(snap, background=True)
    assert len(rows_sync) > 0
    _assert_rows_equal(rows_bg, rows_sync)
    assert dict(app_bg.stats) == dict(app_sync.stats)
    _assert_plans_equal(app_bg.engine.plan, app_sync.engine.plan)
    assert app_bg.engine.manager.info()["incremental_rebuilds"] == 7
    assert app_bg.engine.manager._pool is None  # closed


def test_failed_background_build_falls_back_to_the_sync_build():
    """A build that raises on the worker thread is dropped; the consuming
    thread builds the same epoch itself."""
    _, t_coord = _worlds()
    mgr = PlanManager(device="cpu", coordinator=t_coord, background=True)
    build = mgr._build
    failed = []

    def worker_fails(snapshot, *args):
        if threading.current_thread().name.startswith("plan-recompactor"):
            failed.append(snapshot.i)
            raise RuntimeError("planted worker failure")
        return build(snapshot, *args)

    mgr._build = worker_fails
    app = METLApp(t_coord, plan_manager=mgr)
    try:
        ev = churn_schedule(build_scenario(CFG).registry, steps=1, first_chunk=0, seed=9)[0]
        t_coord.apply(_port_event(ev))
        app.refresh()
    finally:
        mgr.close()
    assert failed == [t_coord.registry.state]
    lease = app.engine.lease
    assert lease.state == t_coord.registry.state and lease.incremental and lease.epoch == 2
    full = tdmm.compile_fused(tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry),
                              t_coord.registry, device="cpu")
    _assert_plans_equal(lease.plan, full)


def test_hit_counts_survive_concurrent_builds():
    """``record_hits`` from many threads while a background worker and the
    caller build epochs: no count is lost (switch interval shortened)."""
    _, t_coord = _worlds()
    mgr = PlanManager(device="cpu", coordinator=t_coord, background=True,
                      tiering=TieringPolicy(min_hits=50))
    n_threads, n_calls = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def feed():
            for _ in range(n_calls):
                mgr.record_hits([((0, 1), 1)])

        threads = [threading.Thread(target=feed) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for k in range(20):
            t_coord.registry.bump_state()
            mgr._on_coordinator_evict(t_coord.registry.state)
            mgr.acquire(t_coord.snapshot(), t_coord.registry)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        mgr.close()
    assert mgr._hits == {(0, 1): n_threads * n_calls}
    assert mgr.info()["rebuilds"] == 20


def test_follower_publishes_nothing():
    """On a follower replica the manager keeps its epochs local: its log
    carries only the leader's records."""
    _, t_coord = _worlds()
    t_coord.replication = types.SimpleNamespace(role="follower")
    mgr = PlanManager(device="cpu", coordinator=t_coord, publish=True)
    mgr.acquire(t_coord.snapshot(), t_coord.registry)
    assert mgr.info()["plan_epoch"] == 1 and t_coord.control_log == []


def test_published_epochs_equal_the_reference_and_replay():
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_coord, t_coord = decode_snapshot(snap), coordinator_from_snapshot(snap)
    r_app = RMETLApp(r_coord, plan_manager=RPlanManager(kind="fused", coordinator=r_coord,
                                                        publish=True))
    t_app = METLApp(t_coord, plan_manager=PlanManager(device="cpu", coordinator=t_coord,
                                                      publish=True))
    _churn_consume(r_app, [t_app])
    r_log, t_log = r_coord.control_log, t_coord.control_log
    assert [type(r.event).__name__ for r in t_log] == [type(r.event).__name__ for r in r_log]
    assert [(r.seq, r.state) for r in t_log] == [(r.seq, r.state) for r in r_log]
    pubs = [r.event for r in t_log if isinstance(r.event, PlanPublished)]
    r_pubs = [r.event for r in r_log if isinstance(r.event, rcontrol.PlanPublished)]
    assert len(pubs) == 8
    for got, want in zip(pubs, r_pubs, strict=True):
        for name in ("epoch", "state", "kind", "incremental", "touched_columns", "n_blocks",
                     "bytes_resident"):
            assert getattr(got, name) == getattr(want, name), name
    assert [p.incremental for p in pubs] == [False] + [True] * 7
    assert pubs[-1].bytes_resident == t_app.engine.info()["bytes_resident"]
    seed = t_build_scenario(CFG)
    replayed = replay_control_log(t_log, seed.registry, seed.dpm)
    assert replayed.registry.state == t_coord.registry.state
    assert replayed.snapshot().dpm == t_coord.snapshot().dpm
    assert len(replayed.control_log) == len(t_log)
    # without publish the log holds the churn only
    sc2 = build_scenario(CFG)
    snap2 = encode_snapshot(RCoordinator(sc2.registry, sc2.dpm))
    _, app = _published_run(snap2)
    assert not any(isinstance(r.event, PlanPublished) for r in app.coordinator.control_log)


def test_inflight_chunk_drains_on_its_epoch_across_a_publish():
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    events = REventSource(sc.registry, seed=5, p_duplicate=0.0).slice(0, 64)
    want = RMETLApp(decode_snapshot(snap)).consume(events)
    t_coord = coordinator_from_snapshot(snap)
    app = METLApp(t_coord, plan_manager=PlanManager(device="cpu", coordinator=t_coord,
                                                    publish=True))
    dense = app.engine.densify(app.triage(_port_events(events)))
    old_plan = dense.plan
    old_table = old_plan.src2d.clone()
    ev = churn_schedule(sc.registry, steps=1, first_chunk=0, seed=9)[0]
    t_coord.apply(_port_event(ev))
    app.refresh()
    assert app.engine.lease.epoch == 2 and app.engine.lease.incremental
    assert dense.plan is old_plan and torch.equal(old_plan.src2d, old_table)
    _assert_rows_equal(app.engine.emit(app.engine.dispatch(dense)), want)


# ---------------------------------------------------------------------------
# the app's reference members
# ---------------------------------------------------------------------------


def test_consume_scalar_state_and_engine_name_equal_the_reference():
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app, t_app = RMETLApp(decode_snapshot(snap)), METLApp(coordinator_from_snapshot(snap),
                                                             device="cpu")
    events = REventSource(sc.registry, seed=4, p_duplicate=0.0, p_stale=0.2).slice(0, 80)
    got, want = t_app.consume_scalar(_port_events(events)), r_app.consume_scalar(events)
    assert len(want) > 0
    assert [dataclasses.asdict(m) for m in got] == [dataclasses.asdict(m) for m in want]
    assert t_app.state == r_app.state == sc.registry.state
    assert t_app.engine_name == r_app.engine_name == "fused"
    assert METLApp(coordinator_from_snapshot(snap), device="cpu",
                   engine="blocks").engine_name == "blocks"


# ---------------------------------------------------------------------------
# the soak of bench_compaction.py, at its smoke size
# ---------------------------------------------------------------------------


def _soak_arm(cfg, sched, *, n_chunks, size, incremental=True, tiering=None):
    """One soak arm on the CPU: a fresh world, the churn schedule applied at
    chunk boundaries; returns (rows, app, manager info)."""
    sc = t_build_scenario(cfg)
    coord = TCoordinator(sc.registry, sc.dpm)
    mgr = PlanManager(device="cpu", coordinator=coord, incremental=incremental,
                      tiering=tiering)
    app = METLApp(coord, plan_manager=mgr)
    src = TEventSource(sc.registry, seed=5)
    rows = []
    for k in range(n_chunks):
        if k in sched:
            coord.apply(_port_event(sched[k]))
        rows += app.consume(src.slice_columnar(k * size, size))
    return rows, app, mgr.info()


def test_soak_arms_equal_each_other_and_the_reference():
    """``bench_compaction.py --smoke``'s soak (16 x 3, 12 chunks of 64
    events, 6 churn steps every 2 chunks): arm A (incremental) equals arm B
    (full rebuild) in order and the reference's incremental arm bit for
    bit; arm C (tiered, latest versions pinned) equals A by key, holds
    fewer resident bytes and took the cold path."""
    n_chunks, size, churn = 12, 64, 6
    cfg = soak_config(smoke=True)
    assert dataclasses.asdict(t_soak_config(smoke=True)) == dataclasses.asdict(cfg)
    sc = build_scenario(cfg)
    r_coord = RCoordinator(sc.registry, sc.dpm)
    sched = churn_schedule(r_coord.registry, steps=churn, first_chunk=1, every=2, seed=13)
    a_rows, a_app, a_info = _soak_arm(cfg, sched, n_chunks=n_chunks, size=size)
    b_rows, _, b_info = _soak_arm(cfg, sched, n_chunks=n_chunks, size=size,
                                  incremental=False)
    n0 = masked_gather.launches, ops.dispatch_count
    c_rows, c_app, c_info = _soak_arm(
        cfg, sched, n_chunks=n_chunks, size=size,
        tiering=TieringPolicy(min_hits=10**9, pin_latest=True))
    assert masked_gather.launches == n0[0]  # the CPU runs the plain version
    assert ops.dispatch_count > n0[1]
    r_app = RMETLApp(r_coord, plan_manager=RPlanManager(kind="fused", coordinator=r_coord))
    r_src = REventSource(sc.registry, seed=5)
    r_rows = []
    for k in range(n_chunks):
        if k in sched:
            r_coord.apply(sched[k])
        r_rows += r_app.consume(r_src.slice_columnar(k * size, size))
    assert len(a_rows) > 0
    _assert_rows_equal(a_rows, r_rows)
    assert dict(a_app.stats) == dict(r_app.stats)
    assert [r[3] for r in a_rows] == [r[3] for r in b_rows]
    _assert_rows_equal(b_rows, a_rows)
    _assert_rows_equal(_sorted_rows(c_rows), _sorted_rows(a_rows))
    assert a_info["incremental_rebuilds"] == churn and b_info["incremental_rebuilds"] == 0
    assert c_info["cold_columns"] > 0 and c_app.stats["tier_misses"] > 0
    assert c_info["bytes_resident"] < a_info["bytes_resident"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("device_densify", [False, True])
def test_tiered_chunk_on_the_card_equals_the_cpu(hopper, device_densify):
    """One tiered chunk (latest versions pinned, the rest cold): its cold
    rows map through the Hopper masked_gather, bit for bit with the CPU."""
    sc = build_scenario(ScenarioConfig(seed=98))
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    chunk = _port_events(REventSource(sc.registry, seed=5).slice(0, 256))
    out = []
    for device in (hopper, "cpu"):
        coord = coordinator_from_snapshot(snap)
        mgr = PlanManager(device=device, coordinator=coord,
                          tiering=TieringPolicy(min_hits=10**9, pin_latest=True))
        app = METLApp(coord, plan_manager=mgr, device_densify=device_densify)
        n0 = masked_gather.launches
        rows = app.consume(chunk)
        out.append((rows, dict(app.stats), masked_gather.launches - n0))
    (got, got_stats, launched), (want, want_stats, cpu_launched) = out
    assert got_stats["tier_misses"] > 0 and got_stats == want_stats
    assert launched > 0 and cpu_launched == 0
    _assert_rows_equal(got, want)
