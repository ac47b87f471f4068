"""The port's sharded mapping engine against the reference's, on the CPU.

The reference partitions the fused block table over a 1 x N JAX mesh and
runs its ``*_shard`` kernels under ``shard_map``; its multi-shard cases need
N devices, which JAX fixes when it starts, so they run in a subprocess with
a forced host device count (``tests/_subproc.run_sub``).  The port's mesh is
an explicit device list, here ``["cpu"] * 4``, and runs in any process.

Covered: the partitioned table (byte for byte, and its per-shard views),
both sharded ops (against the reference's Pallas ``*_shard`` kernels in
interpret mode and its jnp oracles), sharded consume with host and device
densify across a schema evolution and a refresh with replay (rows bit for
bit, ``stats`` equal, one dispatch a chunk), the fused fallback for one
shard or no mesh, and the refusals.  The CUDA kernels against their plain
versions are in ``tests/test_torch_kernels.py`` (marker ``gpu``); the
``gpu`` tests here run four shards on one card and, on a host with two or
four cards, over several cards, against the CPU.  Every
comparison is exact: the sharded path only selects values.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import dmm_jax as rdmm
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario
from repro.etl import EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.transport import decode_snapshot, encode_snapshot

from repro_torch.core import dmm_torch as tdmm
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import FusedEngine, METLApp, PlanManager, ShardedEngine
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_etl_mesh

from _subproc import run_sub as _run_sub
from test_torch_metl import (  # noqa: F401  (hopper: the card fixture)
    CFG, STAT_KEYS, _apps, _assert_rows_equal, _port_events, _run_stream, hopper,
)

run_sub = functools.partial(_run_sub, devices=4)
TESTS = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("chip_smoke", TESTS.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

N = 4  # shards of the multi-shard cases


def _in_subprocess(call: str) -> str:
    """Run ``call`` (an expression over this module, imported as ``t``) in a
    process that sees four JAX CPU devices."""
    return run_sub(f"""
        import sys
        sys.path.insert(0, {str(TESTS)!r})
        import test_torch_sharded as t
        {call}
        print("subprocess OK")
    """)


def _cpu_mesh(n=N):
    return make_etl_mesh(devices=["cpu"] * n)


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the partitioned table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lowered():
    sc = build_scenario(ScenarioConfig(seed=41))
    coord = RCoordinator(sc.registry, sc.dpm)
    t_coord = coordinator_from_snapshot(encode_snapshot(coord))
    r_compiled = rdmm.compile_dpm(coord.snapshot().dpm, coord.registry)
    t_compiled = tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry)
    return coord.registry, r_compiled, t_coord.registry, t_compiled


@pytest.mark.parametrize("n", [1, 3, 4, 64])
def test_sharded_table_equals_reference(lowered, n):
    r_reg, r_compiled, t_reg, t_compiled = lowered
    ref = rdmm.compile_fused_sharded(r_compiled, r_reg, n_shards=n)
    got = tdmm.compile_fused_sharded(t_compiled, t_reg, n_shards=n, device="cpu")
    assert len(got.src3d) == 1  # every shard on the one device: one stack
    _assert_exact(got.src3d[0].numpy(), ref.src3d)
    for key in ("n_shards", "blocks_per_shard", "n_blocks", "width", "n_in_pad",
                "n_blocks_pad_loc", "table_bytes_per_shard"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.table_bytes == int(ref.src3d.nbytes)
    assert got.routes == ref.routes
    _assert_exact(got.n_out, ref.n_out)
    for s in range(n):
        assert got.shard_slice(s) == ref.shard_slice(s)
        assert got.shard_routes(s) == ref.shard_routes(s)
        _assert_exact(got.shard_n_out(s), ref.shard_n_out(s))
    for name in ("uid_slot", "uid_col", "col_block_start", "col_block_count"):
        _assert_exact(getattr(got, name), getattr(ref, name))
    _assert_exact(got.uid_slot_dev[0].numpy(), ref.uid_slot)
    _assert_exact(got.uid_col_dev[0].numpy(), ref.uid_col)


def test_sharded_plan_from_a_mesh_and_from_the_manager(lowered):
    _, _, t_reg, t_compiled = lowered
    host = tdmm.compile_fused_sharded(t_compiled, t_reg, n_shards=N, device="cpu")
    mesh = _cpu_mesh()
    placed = tdmm.compile_fused_sharded(t_compiled, t_reg, mesh=mesh)
    assert placed.groups == mesh.groups
    assert torch.equal(placed.src3d[0], host.src3d[0])
    with pytest.raises(ValueError, match="mesh's 4 shards"):
        tdmm.compile_fused_sharded(t_compiled, t_reg, mesh=mesh, n_shards=3)
    with pytest.raises(ValueError, match="need a mesh or an explicit n_shards"):
        tdmm.compile_fused_sharded(t_compiled, t_reg, device="cpu")


# ---------------------------------------------------------------------------
# the sharded ops: port on the CPU, reference on a 4-device CPU mesh
# ---------------------------------------------------------------------------


def _ops_parity(op: str, impl: str) -> None:
    """Run in a 4-device process: the port's sharded op against the
    reference's (``impl`` "fused": Pallas ``*_shard`` in interpret mode;
    "ref": its jnp oracle), over ``chip_smoke``'s random shard cases."""
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    r_mesh, t_mesh = r_make_etl_mesh(N), _cpu_mesh()
    if op == "gather":
        cases = [c for c in smoke.SHARD_GATHER_CASES if len(c[-1]) == N]
        for i, case in enumerate(cases):
            arrays = smoke.random_sharded_gather(np.random.default_rng(3000 + i), *case)
            for fill in (0.0, 0.25):
                rv, rm = rops.dmm_apply_sharded(*map(jnp.asarray, arrays), mesh=r_mesh,
                                                impl=impl, fill=fill)
                n0 = ops.dispatch_count
                tv, tm = ops.dmm_apply_sharded(*map(torch.from_numpy, arrays), mesh=t_mesh,
                                               fill=fill)
                assert ops.dispatch_count - n0 == 1
                _assert_exact(tv.numpy(), rv)
                _assert_exact(tm.numpy(), rm)
    else:
        cases = [c for c in smoke.SHARD_DENSIFY_CASES if len(c[-1]) == N]
        for i, case in enumerate(cases):
            packed, slot, col, src3d, sizes = smoke.random_sharded_packed(
                np.random.default_rng(4000 + i), *case)
            for fill in (0.0, 0.25):
                rv, rm = rops.dmm_apply_columnar_sharded(
                    *map(jnp.asarray, (packed, slot, col, src3d)), mesh=r_mesh,
                    impl=impl, fill=fill, **sizes)
                n0 = ops.dispatch_count
                tv, tm = ops.dmm_apply_columnar_sharded(
                    *map(torch.from_numpy, (packed, slot, col, src3d)), mesh=t_mesh,
                    fill=fill, **sizes)
                assert ops.dispatch_count - n0 == 1
                _assert_exact(tv.numpy(), rv)
                _assert_exact(tm.numpy(), rm)
    assert cases


@pytest.mark.parametrize("impl", ["fused", "ref"])
@pytest.mark.parametrize("op", ["gather", "columnar"])
def test_sharded_ops_match_reference(op, impl):
    assert "subprocess OK" in _in_subprocess(f"t._ops_parity({op!r}, {impl!r})")


def test_sharded_ops_refuse_a_table_off_the_mesh():
    vals, mask, rows, blks, src3d = map(torch.from_numpy, smoke.random_sharded_gather(
        np.random.default_rng(0), *smoke.SHARD_GATHER_CASES[1]))
    with pytest.raises(ValueError, match="puts shards"):
        ops.dmm_apply_sharded(vals, mask, rows, blks, src3d[:3], mesh=_cpu_mesh())
    with pytest.raises(ValueError, match="table stacks"):
        ops.dmm_apply_sharded(vals, mask, rows, blks, [src3d, src3d], mesh=_cpu_mesh())


# ---------------------------------------------------------------------------
# sharded consume: port on ["cpu"] * 4, reference on a 4-device CPU mesh
# ---------------------------------------------------------------------------


def _sharded_apps(device_densify):
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app = RMETLApp(decode_snapshot(snap), engine="sharded", mesh=r_make_etl_mesh(N),
                     device_densify=device_densify)
    t_app = METLApp(coordinator_from_snapshot(snap), engine="sharded", mesh=_cpu_mesh(),
                    device_densify=device_densify)
    return r_app, t_app


def _consume_parity(device_densify: bool) -> None:
    """Run in a 4-device process: ``_run_stream`` (duplicates, stale and
    parked events, odd payloads, one ``SchemaEvolved``, the refresh that
    replays the parked events) through both sharded apps at two chunk
    sizes; rows and ``stats`` equal, one dispatch a chunk."""
    for chunk_size in (40, 200):
        r_app, t_app = _sharded_apps(device_densify)
        assert isinstance(t_app.engine, ShardedEngine)
        n0 = ops.dispatch_count
        assert _run_stream(r_app, t_app, chunk_size) > 0
        assert dict(t_app.stats) == dict(r_app.stats)
        for key in STAT_KEYS:
            assert t_app.stats[key] == r_app.stats[key], key
        for key in ("parked", "replayed", "refreshes", "unknown_uid"):
            assert r_app.stats[key] > 0, key
        # one dispatch a chunk: the port's op counter, the app's and the
        # reference's agree
        assert ops.dispatch_count - n0 == t_app.stats["dispatches"] == r_app.stats["dispatches"]
        r_info, t_info = r_app.engine.info(), t_app.engine.info()
        for key in ("n_shards", "device_densify", "dispatches", "transfers", "state",
                    "n_blocks", "blocks_per_shard", "width", "table_bytes",
                    "table_bytes_per_shard", "bytes_resident", "plan_epoch",
                    "rebuilds", "role"):
            assert t_info[key] == r_info[key], key


@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_consume_matches_reference(device_densify):
    assert "subprocess OK" in _in_subprocess(f"t._consume_parity({device_densify})")


@pytest.mark.parametrize("device_densify,transfers", [(False, 4), (True, 1)])
def test_sharded_rows_equal_fused_rows_one_dispatch_per_chunk(device_densify, transfers):
    """In this process: the sharded app against the port's fused app (held
    to the reference by tests/test_torch_metl.py) chunk by chunk."""
    r_app, f_app = _apps(device_densify)
    s_app = METLApp(coordinator_from_snapshot(encode_snapshot(r_app.coordinator)),
                    engine="sharded", mesh=_cpu_mesh(), device_densify=device_densify)
    src = REventSource(r_app.coordinator.registry, seed=6, p_duplicate=0.0)
    for k in range(3):
        chunk = _port_events(src.slice(k * 64, 64))
        d0, x0, n0 = s_app.stats["dispatches"], s_app.stats["transfers"], ops.dispatch_count
        got = s_app.consume(chunk)
        assert s_app.stats["dispatches"] - d0 == 1 == ops.dispatch_count - n0
        assert s_app.stats["transfers"] - x0 == transfers
        _assert_rows_equal(got, f_app.consume(chunk))
    assert dict(s_app.stats) == dict(f_app.stats)
    info = s_app.engine.info()
    assert info["engine"] == "sharded" and info["n_shards"] == N
    assert info["device"] == "cpu" and info["device_densify"] is device_densify
    assert info["table_bytes"] == info["bytes_resident"] == N * info["table_bytes_per_shard"]


def test_sharded_pad_rows_and_empty_shards_emit_nothing():
    """64 shards over the scenario's blocks: most shards are empty or hold
    one block, and every shard's routing is padded to a shared S_loc."""
    r_app, f_app = _apps(False)
    s_app = METLApp(coordinator_from_snapshot(encode_snapshot(r_app.coordinator)),
                    engine="sharded", mesh=_cpu_mesh(64))
    chunk = _port_events(REventSource(r_app.coordinator.registry, seed=2).slice(0, 100))
    _assert_rows_equal(s_app.consume(chunk), f_app.consume(chunk))
    plan = s_app.engine.plan
    assert plan.blocks_per_shard * 64 >= plan.n_blocks
    assert any(plan.shard_slice(s)[0] >= plan.n_blocks for s in range(64))
    assert dict(s_app.stats) == dict(f_app.stats)


# ---------------------------------------------------------------------------
# fallback, routing and refusals
# ---------------------------------------------------------------------------


def test_sharded_engine_falls_back_on_single_shard():
    """engine="sharded" with one shard or no mesh is the fused engine, as
    tests/test_sharded_engine.py holds the reference."""
    from repro.launch.mesh import make_etl_mesh as r_make_etl_mesh

    sc = build_scenario(ScenarioConfig(seed=41))
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app = RMETLApp(decode_snapshot(snap), engine="sharded", mesh=r_make_etl_mesh())
    events = REventSource(sc.registry, seed=4).slice(0, 100)
    want = r_app.consume(events)
    assert len(want) > 0
    for kwargs in ({"mesh": _cpu_mesh(1)}, {"device": "cpu"}):
        app = METLApp(coordinator_from_snapshot(snap), engine="sharded", **kwargs)
        assert isinstance(app.engine, FusedEngine) and app.engine.info()["n_shards"] == 1
        _assert_rows_equal(app.consume(_port_events(events)), want)


def test_sharded_mesh_and_engine_refusals():
    with pytest.raises(ValueError, match="need 5 devices for 5 shards"):
        make_etl_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must be adjacent"):
        make_etl_mesh(devices=["cpu", "meta", "cpu"])
    # one device type: a mixed list would map card tensors on the CPU
    for devices in (["cpu", "cpu", "meta", "meta"], ["meta"] * 4):
        with pytest.raises(ValueError, match="all 'cuda' or all 'cpu'"):
            make_etl_mesh(devices=devices)
    assert make_etl_mesh(2, devices=["cpu"] * 4).shape == {"data": 2, "model": 1}
    mesh = _cpu_mesh()
    coord = coordinator_from_snapshot(encode_snapshot(_apps(False)[0].coordinator))
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        METLApp(coord, engine="sharded", mesh=mesh, device="meta")
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedEngine(mesh=None)
    with pytest.raises(ValueError, match="needs a mesh"):
        PlanManager(kind="sharded", device="cpu")
    with pytest.raises(ValueError, match="manager builds 'sharded'"):
        FusedEngine(device="cpu", manager=PlanManager(kind="sharded", mesh=mesh))
    with pytest.raises(ValueError, match="another mesh"):
        ShardedEngine(mesh=mesh, manager=PlanManager(kind="sharded", mesh=_cpu_mesh()))
    with pytest.raises(ValueError, match="no device-densify path"):
        METLApp(coord, engine="blocks", mesh=mesh, device_densify=True)
    app = METLApp(coord, engine="sharded", mesh=mesh, impl="onehot")
    assert app.engine.name == "blocks" and app.engine.impl == "onehot"
    inst = ShardedEngine(mesh=mesh)
    assert METLApp(coord, engine=inst).engine is inst
    with pytest.raises(ValueError, match="mesh= conflicts"):
        METLApp(coord, engine=inst, mesh=_cpu_mesh())


def test_sharded_engine_raises_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    coord = coordinator_from_snapshot(encode_snapshot(_apps(False)[0].coordinator))
    for make in (lambda: make_etl_mesh(),
                 lambda: make_etl_mesh(devices=["cuda"] * 4),
                 lambda: METLApp(coord, engine="sharded",
                                 mesh=make_etl_mesh(devices=["cuda:0"] * 4))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("device_densify", [False, True])
def test_sharded_consume_on_the_card_equals_the_cpu(hopper, device_densify):
    """Four shards on one card against four on the CPU (held to the
    reference above), with one launch of the path's shard kernel a chunk."""
    from repro_torch.kernels import densify_map, segmented_gather

    r_app, _ = _apps(device_densify)
    snap = encode_snapshot(r_app.coordinator)
    apps = [METLApp(coordinator_from_snapshot(snap), engine="sharded",
                    mesh=make_etl_mesh(devices=[dev] * N), device_densify=device_densify)
            for dev in (hopper, "cpu")]
    mod = densify_map if device_densify else segmented_gather
    src = REventSource(r_app.coordinator.registry, seed=6, p_duplicate=0.0)
    for k in range(4):
        chunk = _port_events(src.slice(k * 200, 200))
        l0 = mod.shard_launches
        got = apps[0].consume(chunk)
        assert mod.shard_launches - l0 == 1
        _assert_rows_equal(got, apps[1].consume(chunk))
    assert dict(apps[0].stats) == dict(apps[1].stats)


# ---------------------------------------------------------------------------
# over several cards: one launch per card, outputs copied onto the first
# ---------------------------------------------------------------------------

LAYOUTS = {"one_per_card": 4, "two_per_card": 2}  # layout -> cards it needs


def _cards_mesh(layout: str):
    """Four shards over four cards (``make_etl_mesh(4)``, the default
    layout) or two on each of two cards; skips on a host with fewer."""
    need, have = LAYOUTS[layout], torch.cuda.device_count()
    if have < need:
        pytest.skip(f"needs {need} CUDA devices, this host has {have}")
    if layout == "one_per_card":
        return make_etl_mesh(N)
    return make_etl_mesh(devices=[f"cuda:{s // 2}" for s in range(N)])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_ops_over_several_cards_equal_the_plain_versions(hopper, layout):
    """Both sharded ops over a mesh of several cards, each card mapping its
    own shards in one launch on its own table stack and uid tables, against
    the same op on ``["cpu"] * 4``, bit for bit."""
    from repro_torch.kernels import densify_map, segmented_gather

    mesh = _cards_mesh(layout)
    groups, home = mesh.groups, mesh.devices[0]
    assert len(groups) == LAYOUTS[layout]

    def split(t):
        return [t[lo:hi].to(dev) for dev, lo, hi in groups]

    cases = [c for c in smoke.SHARD_GATHER_CASES if len(c[-1]) == N]
    for i, case in enumerate(cases):
        arrays = map(torch.from_numpy, smoke.random_sharded_gather(
            np.random.default_rng(3000 + i), *case))
        v, m, r, b, t = arrays
        want = ops.dmm_apply_sharded(v, m, r, b, t, mesh=_cpu_mesh(), fill=0.25)
        l0 = segmented_gather.shard_launches
        got = ops.dmm_apply_sharded(v.to(home), m.to(home), r.to(home), b.to(home),
                                    split(t), mesh=mesh, fill=0.25)
        assert segmented_gather.shard_launches - l0 == len(groups)
        for g, w in zip(got, want):
            assert g.device == home
            _assert_exact(g.cpu().numpy(), w.numpy())
    cases = [c for c in smoke.SHARD_DENSIFY_CASES if len(c[-1]) == N]
    for i, case in enumerate(cases):
        packed, slot, col, src3d, sizes = smoke.random_sharded_packed(
            np.random.default_rng(4000 + i), *case)
        p, sl, cl, t = map(torch.from_numpy, (packed, slot, col, src3d))
        want = ops.dmm_apply_columnar_sharded(p, sl, cl, t, mesh=_cpu_mesh(), fill=0.25,
                                              **sizes)
        l0 = densify_map.shard_launches
        got = ops.dmm_apply_columnar_sharded(
            p.to(home), [sl.to(dev) for dev, _, _ in groups],
            [cl.to(dev) for dev, _, _ in groups], split(t), mesh=mesh, fill=0.25, **sizes)
        assert densify_map.shard_launches - l0 == len(groups)
        for g, w in zip(got, want):
            assert g.device == home
            _assert_exact(g.cpu().numpy(), w.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("device_densify", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_consume_over_several_cards_equals_the_cpu(hopper, layout, device_densify):
    """The sharded app over several cards against four shards on the CPU:
    rows and ``stats`` equal, one launch per card a chunk, each card
    holding its shards' table stack and the uid tables."""
    from repro_torch.kernels import densify_map, segmented_gather

    mesh = _cards_mesh(layout)
    r_app, _ = _apps(device_densify)
    snap = encode_snapshot(r_app.coordinator)
    apps = [METLApp(coordinator_from_snapshot(snap), engine="sharded", mesh=m,
                    device_densify=device_densify) for m in (mesh, _cpu_mesh())]
    mod = densify_map if device_densify else segmented_gather
    src = REventSource(r_app.coordinator.registry, seed=6, p_duplicate=0.0)
    for k in range(4):
        chunk = _port_events(src.slice(k * 200, 200))
        l0 = mod.shard_launches
        got = apps[0].consume(chunk)
        assert mod.shard_launches - l0 == len(mesh.groups)
        _assert_rows_equal(got, apps[1].consume(chunk))
    assert dict(apps[0].stats) == dict(apps[1].stats)
    plan = apps[0].engine.plan
    for (dev, lo, hi), t, sl, cl in zip(mesh.groups, plan.src3d, plan.uid_slot_dev,
                                        plan.uid_col_dev):
        assert t.device == sl.device == cl.device == dev and t.shape[0] == hi - lo
