"""The per-block engine's one-call-a-chunk launch, against the JAX reference.

``BlocksEngine.densify`` scatters a chunk's payloads into one host arena and
describes its groups and blocks in two int64 tables
(``repro_torch.kernels.blocks``); ``dispatch`` maps them all with one
``ops.dmm_apply_blocks`` call, which on the card is one call into the kernel
library's C launcher and on the CPU walks the same tables through the plain
versions.  Covered here on the CPU: the layout (aligned, disjoint, every
group and block, index-vector offsets equal to the placed plan's views,
payloads equal to the reference's densify); rows kept from a chunk
unchanged while the arenas are reused; an arena taken again before its
chunk was dispatched; a group with no block counting its two transfers;
N_in 0, a non-float32 payload and descriptors outside their buffers.
Per-block consume through the arenas against the reference (gather bit for
bit, onehot values within ``atol=1e-5`` with masks exact, ``stats`` equal)
at chunk sizes 3 and 60 is
``tests/test_torch_blocks.py::test_blocks_consume_matches_reference``.  On a Hopper card (marker ``gpu``) the launcher is held
against the op-level kernels and the plain versions on random descriptor
sets, with its reported copy and launch counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.state import StateCoordinator as RCoordinator
from repro.core.synthetic import build_scenario
from repro.etl import EventSource as REventSource
from repro.etl import METLApp as RMETLApp
from repro.etl.transport import decode_snapshot, encode_snapshot

from repro_torch.core.convert import coordinator_from_snapshot
from repro_torch.etl import METLApp
from repro_torch.kernels import masked_gather as mg_mod
from repro_torch.kernels import onehot_map as oh_mod
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.blocks import ALIGN, BlockChunk

from test_torch_blocks import ATOL_ONEHOT, _blocks_apps
from test_torch_blocks import _assert_rows_close as _assert_onehot_rows_close
from test_torch_metl import CFG, _assert_rows_equal, _port_events

IMPLS = ("gather", "onehot")
PLAIN = {"gather": tref.masked_gather_ref, "onehot": tref.onehot_map_ref}


def _assert_rows_close(got, want, impl):
    (_assert_rows_equal if impl == "gather" else _assert_onehot_rows_close)(got, want)


def _stream(registry, chunk_size, n_chunks):
    src = REventSource(registry, seed=5, p_duplicate=0.1, p_stale=0.05)
    return [list(src.slice(k * chunk_size, chunk_size)) for k in range(n_chunks)]


# ---------------------------------------------------------------------------
# the layout densify writes
# ---------------------------------------------------------------------------


def test_descriptor_layout_covers_every_group_and_block():
    r_app, t_app = _blocks_apps()
    events = REventSource(r_app.coordinator.registry, seed=8, p_duplicate=0.0).slice(0, 120)
    want = r_app.engine.densify(r_app.triage(events))
    dense = t_app.engine.densify(t_app.triage(_port_events(events)))
    plan, chunk = dense.plan, dense.chunk
    g, k = chunk.groups, chunk.blocks
    # every group, in the reference's order, with its payload and keys
    assert dense.columns == [ov for ov, *_ in want.groups]
    assert g.dtype == k.dtype == np.int64 and g.shape == (len(want.groups), 4)
    for i, (ov, keys, vals, mask) in enumerate(want.groups):
        got_v, got_m = dense.payload(i)
        np.testing.assert_array_equal(got_v.view(np.int32), np.asarray(vals).view(np.int32))
        np.testing.assert_array_equal(got_m, np.asarray(mask))
        b = g[i, 2]
        np.testing.assert_array_equal(
            dense.keys[dense.key_start[i] : dense.key_start[i] + b], np.asarray(keys))
    # offsets aligned, regions disjoint and inside the arena
    assert not (g[:, :2] % ALIGN).any()
    spans = sorted((int(o), int(o + n)) for row in g
                   for o, n in ((row[0], 4 * row[2] * row[3]), (row[1], row[2] * row[3])))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= chunk.n_bytes <= chunk.host.numel()
    # every block of every group's column, in plan order, src offsets equal
    # to each src_dev's offset in src_flat, outputs back to back
    base = plan.src_flat.storage_offset()
    want_blocks = [(i, b.src_dev.storage_offset() - base, b.n_out_pad)
                   for i, ov in enumerate(dense.columns) for b in plan.column(*ov)]
    assert [tuple(row[:3]) for row in k.tolist()] == want_blocks
    sizes = g[k[:, 0], 2] * k[:, 2]
    np.testing.assert_array_equal(k[:, 3], np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    assert chunk.n_out == int(sizes.sum())


# ---------------------------------------------------------------------------
# the arenas across chunks (consume against the reference at chunk sizes 3
# and 60: tests/test_torch_blocks.py::test_blocks_consume_matches_reference)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_rows_survive_arena_reuse(impl):
    """Rows emitted from chunk k own their memory: consuming chunks k+1 and
    k+2 (both host arenas reused) leaves them as they were."""
    _, t_app = _blocks_apps(impl)
    chunks = _stream(t_app.coordinator.registry, 60, 3)
    first = t_app.consume(_port_events(chunks[0]))
    kept = [(r[0], r[1].copy(), r[2].copy(), r[3]) for r in first]
    arenas = t_app.engine._arenas
    for events in chunks[1:]:
        assert t_app.consume(_port_events(events))
    assert arenas.turns == [2, 1]
    _assert_rows_equal(first, kept)
    for buf in arenas.bufs:
        assert not any(np.shares_memory(r[1], buf.numpy()) for r in first)


def test_arena_taken_again_before_dispatch_raises():
    _, t_app = _blocks_apps()
    eng = t_app.engine
    chunks = [t_app.triage(_port_events(c)) for c in _stream(t_app.coordinator.registry, 40, 3)]
    stale = eng.densify(chunks[0])
    eng.densify(chunks[1])
    eng.densify(chunks[2])  # takes chunk 0's arena again
    with pytest.raises(RuntimeError, match="taken by a later densify"):
        eng.dispatch(stale)


def test_arenas_grow_by_doubling():
    _, t_app = _blocks_apps()
    arenas = t_app.engine._arenas
    sizes = []
    for n in (10, 70_000, 70_000, 300_000, 10):
        _, _, buf = arenas.take(n)
        assert buf.numel() >= n
        sizes.append(buf.numel())
    # slots 0, 1, 0, 1, 0: each doubles from its own size and never shrinks
    assert sizes == [1 << 16, 1 << 17, 1 << 17, 1 << 19, 1 << 17]


def test_group_without_blocks_counts_two_transfers():
    """A (schema, version) column with events but no block in the plan:
    its payload is still copied, 2 transfers, as the reference counts."""
    sc = build_scenario(CFG)
    o, v = sorted({key[:2] for key in sc.dpm})[0]
    dpm = {key: blk for key, blk in sc.dpm.items() if key[:2] != (o, v)}
    snap = encode_snapshot(RCoordinator(sc.registry, dpm))
    r_app = RMETLApp(decode_snapshot(snap), engine="blocks", impl="ref")
    t_app = METLApp(coordinator_from_snapshot(snap), engine="blocks", device="cpu")
    events = [e for e in REventSource(sc.registry, seed=3, p_duplicate=0.0).slice(0, 200)
              if e.schema_id == o or e.version == v]
    assert any((e.schema_id, e.version) == (o, v) for e in events)
    dense = t_app.engine.densify(t_app.triage(_port_events(events)))
    g = dense.columns.index((o, v))
    assert g not in dense.chunk.blocks[:, 0]
    t_app.reset_dedup()
    _assert_rows_equal(t_app.consume(_port_events(events)), r_app.consume(events))
    groups = {(e.schema_id, e.version) for e in events}
    assert t_app.stats["transfers"] == 2 * len(groups) == r_app.stats["transfers"]
    assert t_app.stats["dispatches"] == r_app.stats["dispatches"] == \
        sum(len(t_app.engine.plan.column(*ov)) for ov in groups)


# ---------------------------------------------------------------------------
# the op on hand-made descriptors
# ---------------------------------------------------------------------------


def _random_chunk(rng, n_groups, *, pin=False, n_in_lo=1, b_hi=64):
    """A random chunk: per group B in [0, b_hi], N_in in [n_in_lo, 40], 0-3
    blocks (some groups with none) of N_out_pad 128 or 256 drawn from one
    flat table; payloads normal with ~70 % of the mask set.  Returns the
    chunk, src_flat and each group's (values, mask) as tensors."""
    n_out_pads = rng.choice([128, 256], size=12)
    src_off = np.concatenate([[0], np.cumsum(n_out_pads)[:-1]])
    n_in_max = 40
    src_flat = np.full(int(n_out_pads.sum()), -1, np.int32)
    for off, n in zip(src_off, n_out_pads):
        k = int(rng.integers(0, n_in_max + 1))
        src_flat[off + rng.choice(n, size=k, replace=False)] = rng.integers(0, n_in_max, k)
    rows = rng.integers(0, b_hi + 1, n_groups)
    rows[rng.random(n_groups) < 0.1] = 0
    n_in = rng.integers(n_in_lo, n_in_max + 1, n_groups)
    picks = [rng.choice(12, size=int(rng.integers(0, 4)), replace=False)
             for _ in range(n_groups)]
    bgroup = np.repeat(np.arange(n_groups), [p.size for p in picks])
    which = np.concatenate(picks).astype(np.int64)
    groups, blocks, n_bytes, n_out = BlockChunk.layout(rows, n_in, bgroup, src_off[which],
                                                       n_out_pads[which])
    host = torch.zeros(max(n_bytes, 1), dtype=torch.uint8, pin_memory=pin)
    chunk = BlockChunk(host, groups, blocks, n_bytes, n_out)
    payloads = []
    for i in range(n_groups):
        vals, mask = chunk.payload(i)
        vals[...] = rng.normal(size=vals.shape)
        mask[...] = rng.random(mask.shape) < 0.7
        payloads.append((torch.from_numpy(vals.copy()), torch.from_numpy(mask.copy())))
    # an index entry must name a column of its group's payload
    for g, so, n, _ in chunk.blocks.tolist():
        seg = src_flat[so : so + n]
        seg[seg >= n_in[g]] = -1
    return chunk, torch.from_numpy(src_flat), payloads


def _per_block(chunk, src_flat, payloads, fn):
    """Each block's (values, mask) outputs from ``fn`` on its group's
    payload, flattened in the chunk's output layout order."""
    out = []
    for g, so, n, _ in chunk.blocks.tolist():
        vals, mask = payloads[g]
        if vals.shape[0]:
            out.append(fn(vals, mask, src_flat[so : so + n]))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("impl", IMPLS)
def test_walk_matches_plain_version_per_block(impl, seed):
    rng = np.random.default_rng(100 + seed)
    chunk, src_flat, payloads = _random_chunk(rng, 12)
    d0 = ops.dispatch_count
    out_v, out_m, copies, launches = ops.dmm_apply_blocks(chunk, src_flat, impl=impl,
                                                          fill=0.25)
    n_live = sum(1 for g, *_ in chunk.blocks.tolist() if chunk.groups[g, 2])
    assert (copies, launches) == (2 * len(chunk.groups), n_live)
    assert ops.dispatch_count - d0 == n_live
    want = _per_block(chunk, src_flat, payloads,
                      lambda v, m, s: PLAIN[impl](v, m, s, fill=0.25))
    live = [blk for blk in chunk.blocks.tolist() if chunk.groups[blk[0], 2]]
    for (g, _, n, off), (wv, wm) in zip(live, want):
        b = int(chunk.groups[g, 2])
        np.testing.assert_array_equal(out_v[off : off + b * n].view(torch.int32).numpy(),
                                      wv.reshape(-1).view(torch.int32).numpy())
        np.testing.assert_array_equal(out_m[off : off + b * n].numpy(), wm.reshape(-1).numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_empty_payload_behaves_as_the_op_level_wrapper(impl):
    """N_in 0 with B > 0: masked_gather raises, as its op-level wrapper does
    (the kernel's on the card; the plain version's index_select on the CPU);
    onehot_map maps every output to fill, as its op-level wrapper does."""
    host = torch.zeros(64, dtype=torch.uint8)
    chunk = BlockChunk(host=host, groups=np.array([[0, 0, 2, 0]], dtype=np.int64),
                       blocks=np.array([[0, 0, 128, 0]], dtype=np.int64),
                       n_bytes=0, n_out=256)
    src = torch.full((128,), -1, dtype=torch.int32)
    src[:3] = 0
    values, mask = torch.zeros((2, 0)), torch.zeros((2, 0), dtype=torch.int8)
    if impl == "gather":
        with pytest.raises(ValueError, match="non-empty payload"):
            ops.dmm_apply_blocks(chunk, src, impl=impl)
        with pytest.raises(RuntimeError, match="index_select"):
            ops.dmm_apply(values, mask, src, impl=impl)
        return
    out_v, out_m, copies, launches = ops.dmm_apply_blocks(chunk, src, impl=impl, fill=0.5)
    wv, wm = ops.dmm_apply(values, mask, src, impl=impl, fill=0.5)
    assert (copies, launches) == (2, 1)
    np.testing.assert_array_equal(out_v.numpy(), wv.reshape(-1).numpy())
    np.testing.assert_array_equal(out_m.numpy(), wm.reshape(-1).numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_non_float32_payload_raises(impl):
    """The launchers take float32 only: densify refuses any other payload
    before it writes the arena (a cast would change the values)."""
    _, t_app = _blocks_apps(impl)
    (events,) = _stream(t_app.coordinator.registry, 40, 1)
    tri = t_app.triage(_port_events(events))
    tri.chunk.vals = tri.chunk.vals.astype(np.float64)
    with pytest.raises(TypeError, match="float32 payload"):
        t_app.engine.densify(tri)


def test_descriptors_outside_their_buffers_raise():
    chunk, src_flat, _ = _random_chunk(np.random.default_rng(4), 6)
    assert chunk.blocks.size
    bad = chunk.blocks.copy()
    bad[-1, 1] = src_flat.numel()  # index vector past src_flat
    with pytest.raises(ValueError, match="outside"):
        ops.dmm_apply_blocks(dataclasses.replace(chunk, blocks=bad), src_flat)
    bad = chunk.groups.copy()
    bad[0, 0] += 4  # unaligned values
    with pytest.raises(ValueError, match="aligned"):
        ops.dmm_apply_blocks(dataclasses.replace(chunk, groups=bad), src_flat)
    with pytest.raises(ValueError, match="group order"):
        ops.dmm_apply_blocks(dataclasses.replace(chunk, blocks=chunk.blocks[::-1].copy()),
                             src_flat)


# ---------------------------------------------------------------------------
# the launcher on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def hopper():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("impl", IMPLS)
def test_launcher_matches_op_level_kernel_and_plain(hopper, impl):
    """Random descriptor sets (B 0-64, N_in 1-40, 0-3 blocks a group):
    the launcher's outputs equal the op-level kernel's and the plain
    version's (gather bit for bit, onehot within atol 1e-5, masks exact),
    and it reports 2 copies a group and one launch a block with B > 0."""
    op_level = {"gather": mg_mod.masked_gather, "onehot": oh_mod.onehot_map}[impl]
    counter = {"gather": mg_mod, "onehot": oh_mod}[impl]
    for seed in range(8):
        rng = np.random.default_rng(500 + seed)
        chunk, src_flat, payloads = _random_chunk(rng, int(rng.integers(1, 40)), pin=True)
        src_dev = src_flat.to(hopper)
        l0, d0 = counter.launches, ops.dispatch_count
        out_v, out_m, copies, launches = ops.dmm_apply_blocks(chunk, src_dev, impl=impl,
                                                              fill=0.25)
        n_live = sum(1 for g, *_ in chunk.blocks.tolist() if chunk.groups[g, 2])
        assert (copies, launches) == (2 * len(chunk.groups), n_live)
        assert counter.launches - l0 == ops.dispatch_count - d0 == n_live
        on_card = [(v.to(hopper), m.to(hopper)) for v, m in payloads]
        kern = _per_block(chunk, src_dev, on_card,
                          lambda v, m, s: op_level(v, m, s, fill=0.25))
        plain = _per_block(chunk, src_flat, payloads,
                           lambda v, m, s: PLAIN[impl](v, m, s, fill=0.25))
        torch.cuda.synchronize()
        got_v, got_m = out_v.cpu(), out_m.cpu()
        live = [blk for blk in chunk.blocks.tolist() if chunk.groups[blk[0], 2]]
        for (g, _, n, off), (kv, km), (pv, pm) in zip(live, kern, plain):
            b = int(chunk.groups[g, 2])
            gv, gm = got_v[off : off + b * n], got_m[off : off + b * n]
            for wv, wm in ((kv.cpu(), km.cpu()), (pv, pm)):
                np.testing.assert_array_equal(gm.numpy(), wm.reshape(-1).numpy())
                if impl == "gather":
                    np.testing.assert_array_equal(gv.view(torch.int32).numpy(),
                                                  wv.reshape(-1).view(torch.int32).numpy())
                else:
                    np.testing.assert_allclose(gv.numpy(), wv.reshape(-1).numpy(),
                                               rtol=0, atol=ATOL_ONEHOT)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", IMPLS)
def test_blocks_consume_on_the_card_counts_from_the_launcher(hopper, impl):
    """The engine on the card against the CPU run, chunk by chunk: rows
    (onehot within atol 1e-5), ``stats``; the kernel's launches equal the
    card's dispatches equal the CPU run's (one per block touched)."""
    _, cpu_app = _blocks_apps(impl)
    _, card_app = _blocks_apps(impl, device=hopper)
    counter = {"gather": mg_mod, "onehot": oh_mod}[impl]
    for events in _stream(cpu_app.coordinator.registry, 60, 4):
        l0, d0, c0 = counter.launches, card_app.stats["dispatches"], cpu_app.stats["dispatches"]
        want = cpu_app.consume(_port_events(events))
        _assert_rows_close(card_app.consume(_port_events(events)), want, impl)
        assert counter.launches - l0 == card_app.stats["dispatches"] - d0 == \
            cpu_app.stats["dispatches"] - c0
    assert dict(card_app.stats) == dict(cpu_app.stats)
    assert card_app.stats["dispatches"] > 0
