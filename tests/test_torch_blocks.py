"""The port's per-block consume path against the JAX reference, on the CPU.

Covers the two per-block kernels' plain versions (``masked_gather_ref``,
``onehot_map_ref``) against the reference's pure-jnp oracles and its Pallas
kernels in interpret mode; the per-block plan functions (``apply_compacted``,
``apply_onehot``, ``map_batch``, ``place_blocks``); the ``densify_chunk_dicts``
oracle; the §6.3 search queries; ``METLApp(engine="blocks")`` against the
reference's over a stream with an evolution; and ``make_engine``'s routing
and conflict rules.  Tolerances: every gather is exact (bit for bit); the
one-hot contraction sums in float32 in another order than the reference, so
its values are held to ``atol=1e-5`` (as ``tests/test_kernels.py`` holds the
Pallas kernel) and its masks bit for bit.  The CUDA kernels against their
plain versions need a Hopper card (marker ``gpu``) and skip here.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import dmm_jax as rdmm
from repro.core.search import reverse_search as r_reverse_search
from repro.core.search import version_progression as r_version_progression
from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import ScenarioConfig, build_scenario
from repro.etl import EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.engines import densify_chunk_dicts as r_densify_chunk_dicts
from repro.etl.transport import decode_snapshot, encode_snapshot
from repro.kernels import ref as jref
from repro.kernels.masked_gather import masked_gather as pallas_masked_gather
from repro.kernels.onehot_map import onehot_map as pallas_onehot_map

from repro_torch.core import dmm_torch as tdmm
from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.core.search import reverse_search, version_progression
from repro_torch.etl import (
    BlocksEngine,
    FusedEngine,
    METLApp,
    PlanManager,
    densify_chunk_dicts,
    make_engine,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.masked_gather import masked_gather as t_masked_gather
from repro_torch.kernels.onehot_map import onehot_map as t_onehot_map

from test_torch_metl import CFG, STAT_KEYS, _assert_rows_equal, _port_events, _run_stream

SHAPES = [  # tests/test_kernels.py::SHAPES
    (1, 1, 128),
    (8, 10, 128),
    (37, 300, 256),
    (130, 1000, 384),
    (256, 128, 128),
]
ATOL_ONEHOT = 1e-5  # float32 sum order; tests/test_kernels.py holds the Pallas kernel so


def _mk_case(b, n_in, n_out, density, seed=0):
    """tests/test_kernels.py::_mk_case, as numpy: each of ``density *
    min(n_in, n_out)`` output slots names a distinct input slot."""
    rng = np.random.default_rng(hash((b, n_in, n_out, density, seed)) % 2**31)
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    mask = (rng.random((b, n_in)) < 0.7).astype(np.int8)
    src = np.full((n_out,), -1, np.int32)
    k = int(density * min(n_in, n_out))
    if k:
        src[rng.choice(n_out, size=k, replace=False)] = rng.choice(n_in, size=k, replace=False)
    return vals, mask, src


def _f32_bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _both(vals, mask, src, dtype):
    """The same case as jnp and torch operands; bfloat16 values are rounded
    from the same float32 numbers on both sides (round to nearest even)."""
    j = [jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(src)]
    t = [torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(src)]
    if dtype == "bfloat16":
        j[0] = j[0].astype(jnp.bfloat16)
        t[0] = t[0].to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# masked_gather / onehot_map: plain versions against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fill", [0.0, 0.25])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n_in,n_out", SHAPES)
def test_masked_gather_ref_matches_reference(b, n_in, n_out, dtype, density, fill):
    (jv, jm, js), (tv, tm, ts) = _both(*_mk_case(b, n_in, n_out, density), dtype)
    ov, om = jref.masked_gather_ref(jv, jm, js, fill=fill)
    pv, pm = pallas_masked_gather(jv, jm, js, fill=fill, interpret=True)
    gv, gm = tref.masked_gather_ref(tv, tm, ts, fill=fill)
    assert gv.dtype == tv.dtype and gm.dtype == torch.int8
    for want_v, want_m in ((ov, om), (pv, pm)):  # exact: a gather only selects
        np.testing.assert_array_equal(_f32_bits(gv.float().numpy()), _f32_bits(want_v))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(want_m))


def test_masked_gather_ref_takes_any_output_width():
    """The port lifts the reference kernel's N_out % 128 tiling rule; the
    oracle has none, and the plain version agrees with it at N_out = 130."""
    vals, mask, src = _mk_case(9, 20, 130, 0.5)
    ov, om = jref.masked_gather_ref(*map(jnp.asarray, (vals, mask, src)), fill=0.25)
    gv, gm = t_masked_gather(*map(torch.from_numpy, (vals, mask, src)), fill=0.25)
    np.testing.assert_array_equal(_f32_bits(gv), _f32_bits(ov))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(om))


@pytest.mark.parametrize("fill", [0.0, 0.25])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("b,n_in,n_out", SHAPES[:3])
def test_onehot_map_ref_matches_reference(b, n_in, n_out, density, fill):
    vals, mask, src = _mk_case(b, n_in, n_out, density, seed=1)
    (jv, jm, js), (tv, tm, ts) = _both(vals, mask, src, "float32")
    ov, om = jref.onehot_map_ref(jv, jm, js, fill=fill)
    pv, pm = pallas_onehot_map(jv, jm, js, fill=fill, interpret=True)
    gv, gm = tref.onehot_map_ref(tv, tm, ts, fill=fill)
    for want_v, want_m in ((ov, om), (pv, pm)):
        np.testing.assert_allclose(gv.numpy(), np.asarray(want_v), rtol=0, atol=ATOL_ONEHOT)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(want_m))


def test_onehot_map_ref_bfloat16_matches_oracle():
    vals, mask, src = _mk_case(37, 300, 256, 0.5, seed=2)
    (jv, jm, js), (tv, tm, ts) = _both(vals, mask, src, "bfloat16")
    ov, om = jref.onehot_map_ref(jv, jm, js, fill=0.25)
    gv, gm = tref.onehot_map_ref(tv, tm, ts, fill=0.25)
    assert gv.dtype == torch.bfloat16
    np.testing.assert_allclose(gv.float().numpy(), np.asarray(ov, np.float32),
                               rtol=0, atol=ATOL_ONEHOT)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(om))


def test_onehot_map_ref_spreads_a_non_finite_value_over_its_row():
    """A true contraction multiplies every payload slot by the one-hot
    column, so inf or NaN anywhere in a row reaches every mask-set output
    of that row, as through the reference's matrix unit; a gather does not."""
    vals, mask, src = _mk_case(8, 10, 128, 0.5, seed=3)
    mask[:] = 1
    vals[2, 0], vals[5, 9] = np.inf, np.nan
    src[src == 0] = -1  # slot 0 itself is mapped nowhere
    args = (vals, mask, src)
    ov, om = jref.onehot_map_ref(*map(jnp.asarray, args), fill=0.25)
    gv, gm = tref.onehot_map_ref(*map(torch.from_numpy, args), fill=0.25)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(om))
    np.testing.assert_allclose(gv.numpy(), np.asarray(ov), rtol=0, atol=ATOL_ONEHOT)
    hit = gm.numpy().astype(bool)
    for row in (2, 5):
        assert np.isnan(gv[row].numpy()[hit[row]]).all()
    assert np.isfinite(gv[0].numpy()).all()
    mv, _ = tref.masked_gather_ref(*map(torch.from_numpy, args), fill=0.25)
    assert np.isfinite(mv[2].numpy()).all()


def test_dmm_apply_routes_by_impl_and_counts():
    vals, mask, src = map(torch.from_numpy, _mk_case(8, 10, 128, 0.5))
    n0 = ops.dispatch_count
    gv, gm = ops.dmm_apply(vals, mask, src, fill=0.25)
    hv, hm = ops.dmm_apply(vals, mask, src, impl="onehot", fill=0.25)
    assert ops.dispatch_count - n0 == 2
    rv, rm = tref.masked_gather_ref(vals, mask, src, fill=0.25)
    np.testing.assert_array_equal(_f32_bits(gv), _f32_bits(rv))
    np.testing.assert_array_equal(gm.numpy(), rm.numpy())
    np.testing.assert_allclose(hv.numpy(), rv.numpy(), rtol=0, atol=ATOL_ONEHOT)
    np.testing.assert_array_equal(hm.numpy(), rm.numpy())
    for impl in ("ref", "fused", "auto"):
        with pytest.raises(ValueError, match="unknown impl"):
            ops.dmm_apply(vals, mask, src, impl=impl)
    assert ops.dispatch_count - n0 == 2  # a refused impl is no dispatch


# ---------------------------------------------------------------------------
# the per-block plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lowered():
    """One build_scenario state lowered by both packages, plus payloads."""
    sc = build_scenario(CFG)
    coord = RCoordinator(sc.registry, sc.dpm)
    t_coord = coordinator_from_snapshot(encode_snapshot(coord))
    r_compiled = rdmm.compile_dpm(coord.snapshot().dpm, coord.registry)
    t_compiled = tdmm.compile_dpm(t_coord.snapshot().dpm, t_coord.registry)
    return sc, r_compiled, t_compiled


def test_block_index_vectors_equal_reference(lowered):
    _, r_compiled, t_compiled = lowered
    assert list(t_compiled.by_column) == list(r_compiled.by_column)
    placed = tdmm.place_blocks(t_compiled, "cpu")
    assert placed.src_flat.numel() * 4 == placed.src_bytes == t_compiled.src_bytes
    for ov, r_blocks in r_compiled.by_column.items():
        for rb, tb, pb in zip(r_blocks, t_compiled.column(*ov), placed.column(*ov)):
            assert (tb.key, tb.n_in, tb.n_out) == (rb.key, rb.n_in, rb.n_out)
            np.testing.assert_array_equal(tb.src, np.asarray(rb.src))
            np.testing.assert_array_equal(pb.src_dev.numpy(), tb.src)
            # a view of the state's one upload, not a copy of its own
            assert pb.src_dev.untyped_storage().data_ptr() == \
                placed.src_flat.untyped_storage().data_ptr()


def test_apply_functions_match_reference(lowered):
    _, r_compiled, t_compiled = lowered
    rng = np.random.default_rng(4)
    n = 0
    for ov, r_blocks in r_compiled.by_column.items():
        n_in = r_blocks[0].n_in
        vals = rng.normal(size=(5, n_in)).astype(np.float32)
        mask = rng.random((5, n_in)) < 0.7
        jv, jm = jnp.asarray(vals), jnp.asarray(mask)
        tv, tm = torch.from_numpy(vals), torch.from_numpy(mask)
        for rb, tb in zip(r_blocks, t_compiled.column(*ov)):
            cv, cm = tdmm.apply_compacted(tb, tv, tm, fill=0.25)
            rv, rm = rdmm.apply_compacted(rb, jv, jm, fill=0.25)
            np.testing.assert_array_equal(_f32_bits(cv), _f32_bits(rv))
            np.testing.assert_array_equal(cm.numpy(), np.asarray(rm))
            hv, hm = tdmm.apply_onehot(tb, tv, tm, fill=0.25)
            qv, qm = rdmm.apply_onehot(rb, jv, jm, fill=0.25)
            np.testing.assert_allclose(hv.numpy(), np.asarray(qv), rtol=0, atol=ATOL_ONEHOT)
            np.testing.assert_array_equal(hm.numpy(), np.asarray(qm))
            np.testing.assert_array_equal(tdmm.onehot_matrix(tb).numpy(),
                                          np.asarray(rdmm.onehot_matrix(rb)))
            n += 1
        t_out = t_compiled.map_batch(*ov, tv, tm)
        r_out = r_compiled.map_batch(*ov, jv, jm)
        assert [k for k, *_ in t_out] == [k for k, *_ in r_out]
        for (_, a, am), (_, b, bm) in zip(t_out, r_out):
            np.testing.assert_array_equal(_f32_bits(a), _f32_bits(b))
            np.testing.assert_array_equal(am.numpy(), np.asarray(bm))
    assert n == t_compiled.n_blocks > 0


def test_search_queries_match_reference():
    sc = build_scenario(ScenarioConfig(seed=31))
    t_coord = coordinator_from_snapshot(encode_snapshot(RCoordinator(sc.registry, sc.dpm)))
    t_dpm, t_reg = t_coord.snapshot().dpm, t_coord.registry
    reg = sc.registry
    n = 0
    for r in reg.range.schema_ids():
        for w in range(1, reg.range.latest_version(r) + 1):
            want = [dataclasses.astuple(p) for p in r_reverse_search(sc.dpm, reg, r, w)]
            got = [dataclasses.astuple(p) for p in reverse_search(t_dpm, t_reg, r, w)]
            assert got == want
            n += len(want)
    for o in reg.domain.schema_ids():
        want = [dataclasses.astuple(d) for d in r_version_progression(sc.dpm, reg, o)]
        got = [dataclasses.astuple(d) for d in version_progression(t_dpm, t_reg, o)]
        assert got == want
    assert n > 0


def test_densify_chunk_dicts_matches_reference():
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    r_app = RMETLApp(decode_snapshot(snap), engine="fused")
    t_app = METLApp(coordinator_from_snapshot(snap), device="cpu")
    events = REventSource(r_app.coordinator.registry, seed=3, p_duplicate=0.0).slice(0, 120)
    groups = {}
    for ev in events:
        groups.setdefault((ev.schema_id, ev.version), []).append(ev)
    t_groups = {ov: _port_events(evs) for ov, evs in groups.items()}
    want = r_densify_chunk_dicts(r_app.engine.plan, groups)
    got = densify_chunk_dicts(t_app.engine.plan, t_groups)
    for f in ("vals", "mask", "row_ids", "blk_ids", "out_keys"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                      b.view(np.int32) if b.dtype == np.float32 else b)
    # and the columnar densify of the same chunk agrees with the oracle
    dense = t_app.engine.densify(t_app.triage(_port_events(events)))
    np.testing.assert_array_equal(dense.vals.view(np.int32), got.vals.view(np.int32))
    np.testing.assert_array_equal(dense.blk_ids, got.blk_ids)


# ---------------------------------------------------------------------------
# the app: per-block consume against the reference
# ---------------------------------------------------------------------------


def _blocks_apps(impl="gather", device="cpu"):
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    # the reference's "ref" impl is the pure-jnp masked_gather oracle
    r_app = RMETLApp(decode_snapshot(snap), engine="blocks",
                     impl="ref" if impl == "gather" else impl)
    t_app = METLApp(coordinator_from_snapshot(snap), engine="blocks", impl=impl,
                    device=device)
    return r_app, t_app


def _assert_rows_close(got, want):
    """The one-hot rows: routes, keys and masks equal, values within
    ``ATOL_ONEHOT``."""
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x[0] == y[0] and x[3] == y[3]
        np.testing.assert_allclose(x[1], np.asarray(y[1]), rtol=0, atol=ATOL_ONEHOT)
        np.testing.assert_array_equal(x[2], np.asarray(y[2]))


@pytest.mark.parametrize("chunk_size", [3, 60])
@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_blocks_consume_matches_reference(impl, chunk_size):
    """Per-block consume (each chunk one call into the launcher on the
    card, the same descriptors walked through the plain versions here)
    against the reference over ``_run_stream``: gather rows bit for bit,
    onehot values within ``ATOL_ONEHOT`` with masks exact; ``stats``,
    ``info()`` and the dispatch counter equal."""
    r_app, t_app = _blocks_apps(impl)
    assert isinstance(t_app.engine, BlocksEngine) and t_app.engine.impl == impl
    d0 = ops.dispatch_count
    n_rows = _run_stream(r_app, t_app, chunk_size, assert_rows=(
        _assert_rows_equal if impl == "gather" else _assert_rows_close))
    assert n_rows > 0
    for key in STAT_KEYS:
        assert t_app.stats[key] == r_app.stats[key], key
    assert dict(t_app.stats) == dict(r_app.stats)
    assert ops.dispatch_count - d0 == t_app.stats["dispatches"]
    info, r_info = t_app.engine.info(), r_app.engine.info()
    assert set(r_info) - {"impl"} <= set(info)
    for key in set(r_info) - {"impl"}:
        assert info[key] == r_info[key], key
    assert info["impl"] == impl and info["device"] == "cpu"


def test_blocks_rows_equal_fused_rows_and_accounting():
    """Both engines emit per column, per block, per event: the same rows.
    The per-block engine makes one dispatch per block a group touches and
    2 transfers per group."""
    sc = build_scenario(CFG)
    snap = encode_snapshot(RCoordinator(sc.registry, sc.dpm))
    fused = METLApp(coordinator_from_snapshot(snap), device="cpu")
    blocks = METLApp(coordinator_from_snapshot(snap), engine="blocks", device="cpu")
    plan = blocks.engine.plan
    events = REventSource(sc.registry, seed=12, p_duplicate=0.0).slice(0, 150)
    groups = {(e.schema_id, e.version) for e in events}
    n0 = ops.dispatch_count
    rows = blocks.consume(_port_events(events))
    _assert_rows_equal(rows, fused.consume(_port_events(events)))
    touched = sum(len(plan.column(*ov)) for ov in groups)
    assert blocks.stats["dispatches"] == touched == ops.dispatch_count - n0 - 1
    assert blocks.stats["transfers"] == 2 * len(groups)
    for key in ("mapped", "empty", "events"):
        assert blocks.stats[key] == fused.stats[key], key


# ---------------------------------------------------------------------------
# routing and conflicts
# ---------------------------------------------------------------------------


def _coord():
    sc = build_scenario(CFG)
    return coordinator_from_snapshot(encode_snapshot(RCoordinator(sc.registry, sc.dpm)))


def test_make_engine_routing_rules():
    onehot = make_engine("fused", impl="onehot", device="cpu")
    assert isinstance(onehot, BlocksEngine) and onehot.impl == "onehot"
    app = METLApp(_coord(), impl="onehot", device="cpu")
    assert isinstance(app.engine, BlocksEngine) and app.engine.info()["impl"] == "onehot"
    assert isinstance(make_engine("fused", device="cpu"), FusedEngine)
    gather = make_engine("blocks", device="cpu")
    assert isinstance(gather, BlocksEngine) and gather.impl == "gather"
    with pytest.raises(ValueError, match="no onehot realisation"):
        make_engine("fused", impl="onehot", device="cpu", device_densify=True)
    with pytest.raises(ValueError, match="no device-densify path"):
        make_engine("blocks", device="cpu", device_densify=True)
    with pytest.raises(ValueError, match="unknown impl"):
        make_engine("blocks", impl="ref", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("nope", device="cpu")
    # without a mesh of more than one shard, engine="sharded" is the fused engine
    assert isinstance(make_engine("sharded", device="cpu"), FusedEngine)
    sharded_onehot = make_engine("sharded", impl="onehot", device="cpu")
    assert isinstance(sharded_onehot, BlocksEngine) and sharded_onehot.impl == "onehot"


def test_make_engine_refuses_conflicting_instance_and_manager():
    inst = BlocksEngine(device="cpu")
    assert make_engine(inst, impl="gather") is inst
    with pytest.raises(ValueError, match="conflicts with engine instance impl"):
        make_engine(inst, impl="onehot")
    with pytest.raises(ValueError, match="conflicts with engine instance impl"):
        METLApp(_coord(), engine=FusedEngine(device="cpu"), impl="onehot")
    with pytest.raises(ValueError, match="consumes plan kind 'blocks'"):
        BlocksEngine(device="cpu", manager=PlanManager(kind="fused", device="cpu"))
    with pytest.raises(ValueError, match="consumes plan kind 'fused'"):
        FusedEngine(device="cpu", manager=PlanManager(kind="blocks", device="cpu"))
    with pytest.raises(ValueError, match="unknown plan kind"):
        PlanManager(kind="nope", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        PlanManager(kind="sharded", device="cpu")
    shared = PlanManager(kind="blocks", device="cpu")
    eng = BlocksEngine(device="cpu", manager=shared)
    METLApp(_coord(), engine=eng)
    assert shared.info()["bytes_resident"] == eng.info()["bytes_resident"] > 0


def test_blocks_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    coord = _coord()
    for make in (lambda: METLApp(coord, engine="blocks"),
                 lambda: METLApp(coord, impl="onehot"),
                 lambda: BlocksEngine(),
                 lambda: PlanManager(kind="blocks")):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def hopper():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _card_case(dev, b, n_in, n_out, density, dtype, seed=0):
    vals, mask, src = _mk_case(b, n_in, n_out, density, seed)
    t = [torch.from_numpy(a).to(dev) for a in (vals, mask, src)]
    if dtype == "bfloat16":
        t[0] = t[0].to(torch.bfloat16)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_gather_kernel_matches_plain(hopper, dtype):
    for case in SHAPES + [(9, 20, 130)]:
        for density in (0.0, 0.3, 1.0):
            args = _card_case(hopper, *case, density, dtype)
            for fill in (0.0, 0.25):
                kv, km = t_masked_gather(*args, fill=fill)
                rv, rm = tref.masked_gather_ref(*args, fill=fill)
                torch.cuda.synchronize()
                np.testing.assert_array_equal(_f32_bits(kv.float().cpu()),
                                              _f32_bits(rv.float().cpu()))
                np.testing.assert_array_equal(km.cpu().numpy(), rm.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onehot_map_kernel_matches_plain(hopper, dtype):
    for case in SHAPES + [(9, 20, 130)]:
        for density in (0.0, 0.3, 1.0):
            args = _card_case(hopper, *case, density, dtype, seed=1)
            for fill in (0.0, 0.25):
                kv, km = t_onehot_map(*args, fill=fill)
                rv, rm = tref.onehot_map_ref(*args, fill=fill)
                torch.cuda.synchronize()
                np.testing.assert_allclose(kv.float().cpu().numpy(), rv.float().cpu().numpy(),
                                           rtol=0, atol=ATOL_ONEHOT)
                np.testing.assert_array_equal(km.cpu().numpy(), rm.cpu().numpy())
    vals, mask, src = _mk_case(8, 10, 128, 0.5, seed=3)
    vals[2, 0], vals[5, 9] = np.inf, np.nan
    args = [torch.from_numpy(a).to(hopper) for a in (vals, mask, src)]
    kv, km = t_onehot_map(*args, fill=0.25)
    rv, rm = tref.onehot_map_ref(*args, fill=0.25)
    np.testing.assert_array_equal(km.cpu().numpy(), rm.cpu().numpy())
    np.testing.assert_allclose(kv.cpu().numpy(), rv.cpu().numpy(), rtol=0, atol=ATOL_ONEHOT)


@pytest.mark.gpu
def test_blocks_on_the_card_matches_reference(hopper):
    r_app, t_app = _blocks_apps(device=hopper)
    _run_stream(r_app, t_app, 60)
    assert dict(t_app.stats) == dict(r_app.stats)
