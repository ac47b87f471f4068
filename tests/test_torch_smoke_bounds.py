"""The byte counts behind ``chip_smoke.py``'s kernel bounds, held against a
walk of every read each kernel's thread makes (the addresses each CUDA thread
loads, in ``kernels/csrc/*.cu``), on small random inputs on the CPU."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _walk_segmented_gather(vals, mask, rows, blks, src2d):
    """Distinct bytes read by one thread per output (s, q), plus the outputs."""
    read = set()
    s_n, w = rows.size, src2d.shape[1]
    for s in range(s_n):
        read |= {("rows", s, 4), ("blks", s, 4)}
        r, t = int(rows[s]), int(blks[s])
        for q in range(w):
            read.add(("src2d", (t, q), 4))
            p = int(src2d[t, q])
            if p >= 0:
                read.add(("mask", (r, p), 1))
                if mask[r, p] != 0:
                    read.add(("vals", (r, p), 4))
    return sum(n for *_, n in read) + s_n * w * 5


def _walk_densify_map(packed, uid_slot, uid_col, src2d, *, n_items, n_events, n_rows, k):
    read = set()
    o = 2 * n_items + 3 * n_events
    w = src2d.shape[1]
    for s in range(n_rows):
        read |= {o + s, o + n_rows + s}
        r = min(max(int(packed[o + s]), 0), n_events - 1)
        t = int(packed[o + n_rows + s])
        read |= {("src2d", t, q) for q in range(w)}
        base = 2 * n_items
        read |= {base + r, base + n_events + r, base + 2 * n_events + r}
        start, count, col = (int(packed[base + i * n_events + r]) for i in range(3))
        for j in range(min(k, count)):
            ix = min(max(start + j, 0), n_items - 1)
            read.add(ix)
            uid = int(packed[ix])
            if 0 <= uid < uid_slot.size:
                read.add(("slot", uid))
                if uid_slot[uid] >= 0:
                    read.add(("col", uid))
                    if uid_col[uid] == col:
                        read.add(n_items + ix)
    return 4 * len(read) + n_rows * w * 5


@pytest.mark.parametrize("seed", range(4))
def test_segmented_gather_bytes_count_only_named_payload(smoke, seed):
    rng = np.random.default_rng(seed)
    b, n_in, w, n_blocks, s = 12, 128, 128, 20, 40
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    mask = (rng.random((b, n_in)) < 0.6).astype(np.int8)
    src2d = np.full((n_blocks, w), -1, np.int32)
    for blk in range(n_blocks):  # ~10 named columns per block, as the paper
        q = rng.choice(w, size=10, replace=False)
        src2d[blk, q] = rng.choice(n_in // 4, size=10, replace=False)
    rows = rng.integers(b, size=s).astype(np.int32)
    blks = rng.integers(n_blocks, size=s).astype(np.int32)
    rows[-5:], blks[-5:] = 0, 0  # bucket padding routes to (0, 0)
    want = _walk_segmented_gather(vals, mask, rows, blks, src2d)
    ops = [torch.from_numpy(a) for a in (vals, mask, rows, blks, src2d)]
    assert smoke.segmented_gather_bytes(*ops) == want
    assert want < sum(x.nbytes for x in ops) + s * w * 5


@pytest.mark.parametrize("case", [
    (24, 7, 8, 60, 50), (64, 32, 32, 200, 120), (30, 16, 16, 1, 60),
    (9, 32, 32, 0, 16), (50, 20, 8, 100, 64),
])
def test_densify_map_bytes_count_only_reached_items(smoke, case):
    n_events, k_max, k, n_uid, n_rows = case
    rng = np.random.default_rng(sum(case))
    packed, slot, col, src2d, sizes = smoke._random_packed(
        rng, n_events=n_events, k_max=k_max, k=k, n_uid=n_uid, n_cols=5,
        n_rows=n_rows, n_blocks=16,
    )
    want = _walk_densify_map(packed, slot, col, src2d, **sizes)
    ops = [torch.from_numpy(a) for a in (packed, slot, col, src2d)]
    assert smoke.densify_map_bytes(*ops, **sizes) == want


def _walk_segmented_gather_shard(vals, mask, rows, blks, src3d, live=None):
    """Distinct bytes read by one thread per output (z, s, q) of a shard
    launch (each shard reads its own routing and table slice, all of them
    the shared payload), plus the outputs; with ``live``, of the first
    ``live[z]`` routing entries of each shard z only."""
    read = set()
    n, s_n = rows.shape
    w = src3d.shape[2]
    live = [s_n] * n if live is None else live
    for z in range(n):
        for s in range(live[z]):
            read |= {("rows", (z, s), 4), ("blks", (z, s), 4)}
            r, t = int(rows[z, s]), int(blks[z, s])
            for q in range(w):
                read.add(("src3d", (z, t, q), 4))
                p = int(src3d[z, t, q])
                if p >= 0:
                    read.add(("mask", (r, p), 1))
                    if mask[r, p] != 0:
                        read.add(("vals", (r, p), 4))
    return sum(b for *_, b in read) + sum(live) * w * 5


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("case", range(3))
def test_segmented_gather_shard_bytes_match_the_kernels_reads(smoke, case, live):
    shape = smoke.SHARD_GATHER_CASES[case]
    arrays = smoke.random_sharded_gather(np.random.default_rng(case), *shape)
    lens = list(shape[-1]) if live else None
    want = _walk_segmented_gather_shard(*arrays, live=lens)
    got = smoke.segmented_gather_shard_bytes(*map(torch.from_numpy, arrays), live=lens)
    assert got == want


def _walk_densify_map_shard(packed, uid_slot, uid_col, src3d, *, n_items, n_events,
                            n_rows, k, n_shards, shard_lo=0, live=None):
    """Distinct bytes read by a ``densify_map_shard`` launch over
    ``src3d``'s shards: each shard's routing and table slice, and the items,
    uid entries and events its rows reach (shared by the shards); with
    ``live``, of the first ``live[z]`` routing entries of each shard z."""
    read = set()
    o = 2 * n_items + 3 * n_events
    w = src3d.shape[2]
    live = [n_rows] * src3d.shape[0] if live is None else live
    for z in range(src3d.shape[0]):
        ro = o + (shard_lo + z) * n_rows
        bo = o + (n_shards + shard_lo + z) * n_rows
        for s in range(live[z]):
            read |= {ro + s, bo + s}
            r = min(max(int(packed[ro + s]), 0), n_events - 1)
            t = int(packed[bo + s])
            read |= {("src3d", z, t, q) for q in range(w)}
            base = 2 * n_items
            read |= {base + r, base + n_events + r, base + 2 * n_events + r}
            start, count, col = (int(packed[base + i * n_events + r]) for i in range(3))
            for j in range(min(k, count)):
                ix = min(max(start + j, 0), n_items - 1)
                read.add(ix)
                uid = int(packed[ix])
                if 0 <= uid < uid_slot.size:
                    read.add(("slot", uid))
                    if uid_slot[uid] >= 0:
                        read.add(("col", uid))
                        if uid_col[uid] == col:
                            read.add(n_items + ix)
    return 4 * len(read) + sum(live) * w * 5


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("case", [0, 2, 4])
@pytest.mark.parametrize("shard_lo", [0, 1])
def test_densify_map_shard_bytes_match_the_kernels_reads(smoke, case, shard_lo, live):
    shape = smoke.SHARD_DENSIFY_CASES[case]
    packed, slot, col, src3d, sizes = smoke.random_sharded_packed(
        np.random.default_rng(case), *shape)
    src3d = src3d[shard_lo:]
    lens = list(shape[-1][shard_lo:]) if live else None
    want = _walk_densify_map_shard(packed, slot, col, src3d, shard_lo=shard_lo, live=lens,
                                   **sizes)
    got = smoke.densify_map_shard_bytes(
        *map(torch.from_numpy, (packed, slot, col, src3d)), shard_lo=shard_lo, live=lens,
        **sizes)
    assert got == want


def _walk_per_block(vals, mask, src, *, reads_all):
    """Distinct bytes read by ``masked_gather``'s threads (one per output
    column: src[q], then mask[b, src[q]] and, on a hit, the value) or by
    ``onehot_map``'s (src, and every staged value and mask), plus the
    outputs."""
    read = set()
    b_n, e = vals.shape[0], vals.itemsize
    for q, p in enumerate(src.tolist()):
        read.add(("src", q, 4))
        if p >= 0 and not reads_all:
            for b in range(b_n):
                read.add(("mask", (b, p), 1))
                if mask[b, p] != 0:
                    read.add(("vals", (b, p), e))
    if reads_all:
        read |= {("vals", i, e) for i in range(vals.size)}
        read |= {("mask", i, 1) for i in range(mask.size)}
    return sum(n for *_, n in read) + b_n * src.size * (e + 1)


@pytest.mark.parametrize("reads_all", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_per_block_bytes_match_the_kernels_reads(smoke, seed, reads_all):
    rng = np.random.default_rng(seed)
    b, n_in, n_out = 5, 12, 128
    vals = rng.normal(size=(b, n_in)).astype(np.float32)
    mask = (rng.random((b, n_in)) < 0.6).astype(np.int8)
    src = np.full(n_out, -1, np.int32)
    src[rng.choice(n_out, size=10, replace=False)] = rng.choice(n_in, size=10)
    want = _walk_per_block(vals, mask, src, reads_all=reads_all)
    ops = [torch.from_numpy(a) for a in (vals, mask, src)]
    assert smoke.per_block_bytes(*ops, reads_all=reads_all) == want


@pytest.mark.parametrize("cdt,edt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("top_k,plant", [(2, ()), (None, ()), (0, ()),
                                         (2, ("nonfinite_weight",))])
def test_moe_bound_counts_every_operand_element(smoke, top_k, plant, cdt, edt):
    """``moe_combine``'s bound reads every element of combine and of
    expert_out once (a non-finite value in any expert_out slot reaches its
    whole column) and writes the output once; its operations are 2 D per
    weight != 0, a NaN weight included."""
    t, e, c, d = 37, 8, 16, 24
    cw, eo = smoke.moe_arrays(t, e, c, d, top_k=top_k, plant=plant)
    nnz = sum(1 for w in cw.ravel() if w != 0)
    bound = smoke.moe_bound(torch.from_numpy(cw).to(cdt), torch.from_numpy(eo).to(edt), 1e12)
    size = torch.tensor([], dtype=edt).element_size()
    assert bound["bytes"] == cw.size * torch.tensor([], dtype=cdt).element_size() + (
        e * c * d + t * d) * size
    assert bound["nonzero_weights"] == nnz and bound["flops"] == 2 * nnz * d
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"])
