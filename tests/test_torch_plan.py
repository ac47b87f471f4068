"""The port's plan lowering and state copies against the JAX reference.

For ``build_scenario`` states, every table of the port's fused plan is
array-equal to the reference ``compile_fused``'s, and so are the shape
helpers and the state the copied numpy modules build from the same seeds.
"""

import numpy as np
import pytest

from repro.core import dmm_jax as rdmm
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig as RConfig
from repro.core.synthetic import build_scenario as r_build_scenario
from repro.core.synthetic import churn_schedule as r_churn_schedule
from repro.etl.transport import encode_snapshot

from repro_torch.core import dmm_torch as tdmm
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.core.state import StateCoordinator as TCoordinator
from repro_torch.core.synthetic import ScenarioConfig as TConfig
from repro_torch.core.synthetic import build_scenario as t_build_scenario
from repro_torch.etl.control import SchemaEvolved as TSchemaEvolved
from repro_torch.etl.plan import PlanManager

CONFIGS = [
    dict(n_schemas=4, versions_per_schema=3, attrs_per_version=6,
         n_entities=2, cdm_attrs=8, seed=1),
    dict(n_schemas=6, versions_per_schema=4, attrs_per_version=10,
         n_entities=3, cdm_attrs=12, seed=2),
    dict(n_schemas=3, versions_per_schema=2, attrs_per_version=140,
         n_entities=1, cdm_attrs=150, seed=3),  # wider than one lane
]


def _reference_plan(coord):
    snap = coord.snapshot()
    compiled = rdmm.compile_dpm(snap.dpm, coord.registry)
    return compiled, rdmm.compile_fused(compiled, coord.registry)


def _port_plan(coord):
    snap = coord.snapshot()
    compiled = tdmm.compile_dpm(snap.dpm, coord.registry)
    return compiled, tdmm.compile_fused(compiled, coord.registry, device="cpu")


def _assert_plans_equal(r_compiled, r_plan, t_compiled, t_plan):
    assert t_plan.state == r_plan.state
    assert (t_plan.n_in_pad, t_plan.width, t_plan.n_blocks) == (
        r_plan.n_in_pad, r_plan.width, r_plan.n_blocks)
    np.testing.assert_array_equal(t_plan.src2d.numpy(), np.asarray(r_plan.src2d))
    assert t_plan.src2d.numpy().dtype == np.int32
    for name in ("n_out", "uid_slot", "uid_col", "col_block_start", "col_block_count"):
        got, want = getattr(t_plan, name), getattr(r_plan, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(t_plan.uid_slot_dev.numpy(), np.asarray(r_plan.uid_slot_dev))
    np.testing.assert_array_equal(t_plan.uid_col_dev.numpy(), np.asarray(r_plan.uid_col_dev))
    assert t_plan.routes == r_plan.routes
    assert list(t_plan.columns) == list(r_plan.columns)
    for ov, col in r_plan.columns.items():
        tc = t_plan.columns[ov]
        assert (tc.n_in, tc.col_id, tc.uid_pos) == (col.n_in, col.col_id, col.uid_pos)
        np.testing.assert_array_equal(tc.block_ids, col.block_ids)
    assert list(t_compiled.by_column) == list(r_compiled.by_column)
    for ov, blocks in r_compiled.by_column.items():
        for rb, tb in zip(blocks, t_compiled.by_column[ov]):
            assert (tb.key, tb.n_in, tb.n_out) == (rb.key, rb.n_in, rb.n_out)
            np.testing.assert_array_equal(tb.src, np.asarray(rb.src))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_fused_plan_tables_equal_reference(cfg):
    sc = r_build_scenario(RConfig(**cfg))
    r_coord = RCoordinator(sc.registry, sc.dpm)
    t_coord = coordinator_from_snapshot(encode_snapshot(r_coord))
    _assert_plans_equal(*_reference_plan(r_coord), *_port_plan(t_coord))


@pytest.mark.parametrize("cfg", CONFIGS[:2])
def test_fused_plan_tables_equal_reference_after_evolution(cfg):
    sc = r_build_scenario(RConfig(**cfg))
    r_coord = RCoordinator(sc.registry, sc.dpm)
    t_coord = coordinator_from_snapshot(encode_snapshot(r_coord))
    for step, ev in sorted(r_churn_schedule(r_coord.registry, steps=2, seed=4).items()):
        r_coord.apply(ev)
        t_coord.apply(TSchemaEvolved(tree=ev.tree, schema_id=ev.schema_id,
                                     keep=ev.keep, add=ev.add))
    assert t_coord.registry.state == r_coord.registry.state
    _assert_plans_equal(*_reference_plan(r_coord), *_port_plan(t_coord))


@pytest.mark.parametrize("cfg", CONFIGS[:2])
def test_global_uid_tables_equal_reference(cfg):
    sc = r_build_scenario(RConfig(**cfg))
    r_coord = RCoordinator(sc.registry, sc.dpm)
    t_coord = coordinator_from_snapshot(encode_snapshot(r_coord))
    r_compiled, _ = _reference_plan(r_coord)
    t_compiled, _ = _port_plan(t_coord)
    for got, want in zip(tdmm.global_uid_tables(t_compiled, t_coord.registry),
                         rdmm.global_uid_tables(r_compiled, r_coord.registry)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", list(range(0, 20)) + [127, 128, 129, 255, 256, 257, 1000])
def test_shape_helpers_equal_reference(n):
    assert tdmm.bucket_rows(n) == rdmm.bucket_rows(n)
    assert tdmm.bucket_rows(n, floor=1) == rdmm.bucket_rows(n, floor=1)
    assert tdmm.pad_to_lane(n) == rdmm.pad_to_lane(n)
    assert tdmm.pad_to_lane(n, lane=8) == rdmm.pad_to_lane(n, lane=8)


def test_uid_lookup_table_equals_reference():
    for uids in ([], [3], [5, 1, 9], list(range(40, 0, -3))):
        got, want = tdmm.uid_lookup_table(uids), rdmm.uid_lookup_table(uids)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", CONFIGS[:2])
def test_scenario_copy_builds_the_reference_state(cfg):
    """The port's copied registry / DPM / synthetic modules build the same
    state from the same seed as the reference's."""
    r_sc = r_build_scenario(RConfig(**cfg))
    t_sc = t_build_scenario(TConfig(**cfg))
    assert t_sc.registry.to_dict() == r_sc.registry.to_dict()
    assert t_sc.dpm == r_sc.dpm
    np.testing.assert_array_equal(t_sc.matrix.M, r_sc.matrix.M)


def test_coordinator_from_snapshot_carries_state():
    sc = r_build_scenario(RConfig(**CONFIGS[0]))
    r_coord = RCoordinator(sc.registry, sc.dpm)
    r_coord.freeze()
    snap = encode_snapshot(r_coord)
    t_coord = coordinator_from_snapshot(snap)
    assert t_coord.registry.to_dict() == r_coord.registry.to_dict()
    assert t_coord.snapshot().dpm == r_coord.snapshot().dpm
    assert t_coord.snapshot().i == r_coord.snapshot().i
    assert t_coord.frozen and t_coord.log_offset == r_coord.log_offset == 1
    with pytest.raises(ValueError, match="wire version"):
        coordinator_from_snapshot({**snap, "v": 2})


def test_plan_manager_caches_by_state_and_rebuilds_on_change():
    sc = t_build_scenario(TConfig(**CONFIGS[0]))
    coord = TCoordinator(sc.registry, sc.dpm)
    mgr = PlanManager(device="cpu")
    assert mgr.info() == {"plan_epoch": 0, "rebuilds": 0, "incremental_rebuilds": 0,
                          "last_rebuild_s": 0.0, "total_rebuild_s": 0.0}
    a = mgr.acquire(coord.snapshot(), coord.registry)
    b = mgr.acquire(coord.snapshot(), coord.registry)
    assert a is b and a.epoch == 1 and mgr.rebuilds == 1
    assert a.bytes_resident == a.plan.src2d.numel() * 4
    coord.registry.bump_state()
    c = mgr.acquire(coord.snapshot(), coord.registry)
    assert c.epoch == 2 and c.state == coord.registry.state and mgr.rebuilds == 2
    info = mgr.info()
    assert info["plan_epoch"] == 2 and info["bytes_resident"] == c.bytes_resident
