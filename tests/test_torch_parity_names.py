"""Public names of the reference whose port counterparts are small helpers,
held against the reference on the same inputs:

  * ``TriagedChunk.to_groups``: the legacy (schema, version) -> events
    view of one triaged chunk, equal event for event;
  * ``DenseChunk.epoch`` / ``ColumnarDense.epoch``: the state a densified
    chunk is pinned to, equal to the reference's before and after a schema
    change;
  * ``launch.dryrun_lib.batch_shardings``: each batch leaf's placement,
    the DTensor form of the reference's ``NamedSharding`` (the same spec,
    by ``_batch_pspec``), over fake meshes and a real one-device mesh.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import build_scenario, churn_schedule
from repro.etl import EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.transport import decode_snapshot, encode_snapshot
from repro.launch import dryrun_lib as RD
from repro.sharding import specs as RS
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import FusedEngine, METLApp
from repro_torch.etl.control import SchemaEvolved as TSchemaEvolved
from repro_torch.launch import dryrun_lib as TD
from repro_torch.sharding import specs as TS

from test_torch_metl import CFG, _port_events


def _apps(device_densify=False):
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app = RMETLApp(decode_snapshot(snap), engine="fused", device_densify=device_densify)
    r_app.engine.min_device_events = 0  # every chunk on the path under test
    t_app = METLApp(coordinator_from_snapshot(snap),
                    engine=FusedEngine(device="cpu", device_densify=device_densify,
                                       min_device_events=0))
    return r_app, t_app


def _events(registry, seed, n=120):
    return REventSource(registry, seed=seed, p_duplicate=0.1, p_stale=0.05).slice(0, n)


@pytest.mark.parametrize("seed", [3, 8])
def test_to_groups_equals_the_reference(seed):
    r_app, t_app = _apps()
    events = _events(r_app.coordinator.registry, seed)
    want = r_app.triage(events).to_groups()
    got = t_app.triage(_port_events(events)).to_groups()
    assert list(got) == list(want) and len(want) > 1
    for ov in want:
        assert [dataclasses.asdict(e) for e in got[ov]] == \
            [dataclasses.asdict(e) for e in want[ov]], ov


@pytest.mark.parametrize("device_densify", [False, True])
def test_dense_chunk_epoch_equals_the_reference(device_densify):
    """The epoch of a chunk densified (host: ``DenseChunk``, device:
    ``ColumnarDense``) before and after a schema evolution recompiles the
    plan."""
    r_app, t_app = _apps(device_densify)
    reg = r_app.coordinator.registry
    ev = churn_schedule(reg, steps=1, first_chunk=1, seed=2)[1]
    epochs = []
    for step in range(2):
        if step == 1:
            r_app.coordinator.apply(ev)
            t_app.coordinator.apply(TSchemaEvolved(tree=ev.tree, schema_id=ev.schema_id,
                                                   keep=ev.keep, add=ev.add))
        events = _events(reg, 5 + step)
        r_dense = r_app.engine.densify(r_app.triage(events))
        t_dense = t_app.engine.densify(t_app.triage(_port_events(events)))
        assert type(t_dense).__name__ == type(r_dense).__name__
        assert t_dense.epoch == r_dense.epoch == t_app.engine.plan.state
        epochs.append(t_dense.epoch)
    assert epochs[1] > epochs[0]


def _leaves(batch):
    return {k: jax.ShapeDtypeStruct(v.shape, np.float32) for k, v in batch.items()}


@pytest.mark.parametrize("shape", [(2, 4), (16, 16), (3, 2), (2, 16, 16)])
def test_batch_shardings_follow_the_references_spec(shape):
    batch = {"tokens": np.zeros((32, 16)), "frames": np.zeros((6, 4, 8)), "w": np.zeros((8,))}
    mesh = TD.ShapeMesh(*shape)
    got = TD.batch_shardings(TS.make_policy(mesh), {k: TD._meta(v.shape, TD.torch.float32)
                                                  for k, v in batch.items()})
    rsp = RS.make_policy(mesh)  # the reference's policy reads the fake mesh's shape
    for k, v in batch.items():
        want = RD._batch_pspec(rsp, v.shape[0], v.ndim)
        assert got[k] == TS.placements(tuple(want), mesh), k


def test_batch_shardings_equal_the_references_on_a_real_mesh():
    from repro.launch.mesh import make_local_mesh

    rmesh = make_local_mesh(1, 1)
    batch = {"tokens": np.zeros((8, 16)), "frames": np.zeros((8, 4, 8))}
    want = RD.batch_shardings(RS.make_policy(rmesh), _leaves(batch))
    mesh = TD.ShapeMesh(1, 1)
    got = TD.batch_shardings(TS.make_policy(mesh), {k: TD._meta(v.shape, TD.torch.float32)
                                                  for k, v in batch.items()})
    for k in batch:
        assert got[k] == TS.placements(tuple(want[k].spec), mesh), k
