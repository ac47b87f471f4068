"""The mapping engine: the device side of the METL app.

Counterpart of ``repro.etl.engines`` for the fused and per-block paths.  A
:class:`MappingEngine` maps *triaged* event chunks to canonical rows through
four explicit stages:

    compile(snapshot, registry)   acquire the device plan for one state from
                                  the engine's PlanManager (the single plan
                                  construction site, repro_torch.etl.plan)
    densify(groups)               host side: payload arrays + routing
    dispatch(dense)               device side: copy in, launch, return an
                                  UNSYNCHRONISED handle
    emit(handle)                  the only sync point: copy back, slice each
                                  surviving row to its block's true width

Densification is pure numpy over columnar chunks, as in the reference.  The
:class:`FusedEngine` maps a whole chunk -- every column, every block -- in
ONE dispatch: with host densify (the default) through the
``segmented_gather`` kernel over a dense payload scattered on the host; with
``device_densify=True`` through the ``densify_map`` kernel, which takes the
chunk's raw (uid, value) items packed into one int32 buffer and resolves,
densifies and maps them in the one launch.  The :class:`BlocksEngine` is the
paper's per-block path: one dispatch per compacted block of each (schema,
version) group, through ``masked_gather`` (``impl="gather"``, the DMM) or
``onehot_map`` (``impl="onehot"``, the matrix-operator baseline).  The
:class:`ShardedEngine` is the fused path with the block table partitioned
over a mesh's shards (:mod:`repro_torch.launch.mesh`): one dispatch a chunk,
one launch of ``segmented_gather_shard`` or ``densify_map_shard`` per device,
rows emitted in the fused engine's order.  Engines are registered by name
(:func:`register_engine`) and resolved by :func:`make_engine`.

Each :class:`DenseChunk` / :class:`ColumnarDense` / :class:`BlockDense`
pins the plan it was densified against, so a state change between stages
never mixes plans.  Every engine densifies into one of two pinned host
arenas (:class:`_HostArenas`) and issues a chunk's copies and launches in
one call (:func:`~repro_torch.kernels.ops.dmm_apply_dense` for host
densify, :func:`~repro_torch.kernels.ops.dmm_apply_packed` for device
densify, :func:`~repro_torch.kernels.ops.dmm_apply_blocks`), counting the
transfers and dispatches that call reports; an arena is written again only
after the event recorded behind its copies has completed.  The fused and
sharded engines' emit reads the chunk's one output allocation back with one
copy into a pinned buffer (:class:`_ReadBack`).

With residency tiering (:class:`~repro_torch.etl.plan.TieringPolicy`) a
lease keeps rarely-hit columns out of the device table: the fused and
sharded engines densify a chunk's events of such columns apart
(:class:`ColdDense`, counted under ``stats["tier_misses"]``) and emit maps
them block by block through ``masked_gather`` on the engine's device, after
the resident rows.

``info()`` is the public observability surface.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..core.dmm_torch import (
    CompiledDMM,
    DeviceLike,
    bucket_rows,
    global_uid_tables,
    resolve_device,
    uid_lookup_table,
)
from ..core.registry import Registry
from ..core.state import SystemState
from ..kernels.blocks import BlockChunk
from ..kernels.densify_map import split_outputs
from ..kernels.ops import (
    IMPLS,
    ChunkOutput,
    dmm_apply,
    dmm_apply_blocks,
    dmm_apply_dense,
    dmm_apply_packed,
)
from ..kernels.segmented_gather import arena_layout, arena_views
from .events import CDCEvent, ColumnarChunk, columnarize
from .plan import ColdColumn, PlanEpoch, PlanManager

__all__ = [
    "CanonicalRow",
    "Groups",
    "TriagedChunk",
    "as_triaged",
    "ColdDense",
    "DenseChunk",
    "ColumnarDense",
    "DispatchHandle",
    "densify_chunk_dicts",
    "MappingEngine",
    "ENGINES",
    "register_engine",
    "make_engine",
    "FusedEngine",
    "ShardedEngine",
    "BlockDense",
    "BlocksEngine",
]


CanonicalRow = Tuple[Tuple[int, int], np.ndarray, np.ndarray, int]
# ((business entity r, version w), values (n_out,), mask (n_out,), event key)

Groups = Dict[Tuple[int, int], List[CDCEvent]]
# legacy triaged-chunk form: (schema o, version v) -> mappable events


@dataclasses.dataclass
class TriagedChunk:
    """One triaged chunk in columnar form: a
    :class:`~repro_torch.etl.events.ColumnarChunk` plus, per (o, v), the
    indices of its mappable events in arrival order."""

    chunk: ColumnarChunk
    by_column: Dict[Tuple[int, int], np.ndarray]  # (o, v) -> event indices

    def __bool__(self) -> bool:
        return bool(self.by_column)


def as_triaged(groups) -> Optional[TriagedChunk]:
    """Coerce any accepted densify input to a non-empty :class:`TriagedChunk`
    (a legacy ``Groups`` dict is columnarised once); None when there is
    nothing to map."""
    if groups is None:
        return None
    if isinstance(groups, TriagedChunk):
        return groups if groups.by_column else None
    if not groups:
        return None
    events = [ev for evs in groups.values() for ev in evs]
    chunk = columnarize(events)
    by_column: Dict[Tuple[int, int], np.ndarray] = {}
    base = 0
    for ov, evs in groups.items():
        idx = [base + k for k in range(len(evs)) if not chunk.bad[base + k]]
        if idx:
            by_column[ov] = np.asarray(idx, dtype=np.int64)
        base += len(evs)
    if not by_column:
        return None
    return TriagedChunk(chunk=chunk, by_column=by_column)


def _excl_cumsum(counts: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum: element i is sum(counts[:i])."""
    out = np.zeros(counts.size, dtype=np.int64)
    np.cumsum(counts[:-1], out=out[1:])
    return out


def _segmented_arange(starts: np.ndarray, counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised ``concatenate([arange(s, s + c) for s, c in ...])``;
    returns the values and, per value, the index of its segment."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    shift = starts - _excl_cumsum(counts)
    values = np.arange(total, dtype=np.int64) + np.repeat(shift, counts)
    seg_of = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    return values, seg_of


def _event_items(chunk: ColumnarChunk, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The payload items of the selected events: ``(ev_rows, item_idx)``,
    the event-local row of each item and its flat position in the chunk."""
    offs = chunk.event_offsets
    starts = offs[idx]
    counts = offs[idx + 1] - starts
    item_idx, ev_rows = _segmented_arange(starts, counts)
    return ev_rows, item_idx


def _uid_slots(lut: np.ndarray, uids: np.ndarray) -> np.ndarray:
    """Bounds-checked dense-table lookup: uid -> slot, -1 for a uid outside
    the table (never an index error)."""
    if lut.size == 0:
        return np.full(uids.shape, -1, dtype=np.int32)
    valid = (uids >= 0) & (uids < lut.size)
    slots = lut[np.where(valid, uids, 0)]
    return np.where(valid, slots, np.int32(-1))


def _count_unknown_uids(
    uid_col: np.ndarray,
    chunk: ColumnarChunk,
    by_column: Dict[Tuple[int, int], np.ndarray],
    stats: collections.Counter,
) -> None:
    """Count payload items whose uid NO column of the plan knows, over all
    triaged events, under ``stats["unknown_uid"]``."""
    if not by_column:
        return
    idx = np.concatenate(list(by_column.values()))
    _, item_idx = _event_items(chunk, idx)
    if item_idx.size:
        n = int((_uid_slots(uid_col, chunk.uids[item_idx]) < 0).sum())
        if n:
            stats["unknown_uid"] += n


@dataclasses.dataclass
class ColdDense:
    """One tier-miss column of a chunk, densified at the column's true
    width against the lease's :class:`~repro_torch.etl.plan.ColdColumn`
    (pinned with it, as the chunk pins its plan).  Emit maps it block by
    block through ``masked_gather``, the slow path a miss pays."""

    col: ColdColumn
    keys: np.ndarray  # (n,) i64 event keys
    vals: np.ndarray  # (n, n_in) f32
    mask: np.ndarray  # (n, n_in) i8


@dataclasses.dataclass
class DenseChunk:
    """One host-densified chunk: payload arrays plus (row, block) routing,
    pinned to the plan it was densified against.

    Densify writes ``vals``, ``mask`` and the padded routing ``rows`` /
    ``blks`` into a host arena (``host``, pinned for a CUDA device; ``slot``
    and ``turn`` of :class:`_HostArenas`) at the offsets of
    :func:`~repro_torch.kernels.segmented_gather.arena_layout`: those four
    are views of it, valid until the arena is taken again.  ``row_ids`` /
    ``blk_ids`` / ``out_keys`` (and ``shard_sel``) keep the host copy of the
    global routing for emit.  The dict-walk oracle
    (:func:`densify_chunk_dicts`) fills only the payload and the global
    routing.  ``cold`` holds the chunk's tier-miss columns; a chunk with no
    resident rows (:func:`_cold_only_chunk`) has no arena and launches
    nothing."""

    plan: Any
    vals: np.ndarray  # (bucket(n_events), n_in_pad) f32
    mask: np.ndarray  # (bucket(n_events), n_in_pad) i8
    row_ids: np.ndarray  # (S,) i32: event row per output row
    blk_ids: np.ndarray  # (S,) i32: global block per output row
    out_keys: np.ndarray  # (S,) i64: event key per output row (emission order)
    # (n_route, S_pad) i32: the fused engine's (1, bucket(S)) routing, or the
    # sharded engine's (n_shards, S_loc) split with shard-local blocks
    rows: Optional[np.ndarray] = None
    blks: Optional[np.ndarray] = None
    host: Optional[torch.Tensor] = None  # the uint8 arena the four views lie in
    slot: int = 0
    turn: int = 0
    shard_sel: Optional[List[np.ndarray]] = None  # per shard: its global output rows
    cold: Optional[List[ColdDense]] = None  # tier-miss columns, emitted after the rest

    def sizes(self) -> Dict[str, int]:
        """The arena's shapes, as :func:`~repro_torch.kernels.ops.
        dmm_apply_dense` takes them."""
        return dict(n_events=self.vals.shape[0], n_in=self.vals.shape[1],
                    n_rows=self.rows.shape[1])


@dataclasses.dataclass
class ColumnarDense:
    """A chunk to be densified ON DEVICE: its raw columnar operands packed
    into one flat int32 buffer

        [ uids(NI) | val_bits(NI) | starts(B) | counts(B) | ev_col(B)
          | rows | blks ]

    (section sizes are the bucketed statics below), so the chunk crosses to
    the device in one transfer.  ``rows``/``blks`` are the (S,) routing, or
    on the sharded path the flattened (n_shards, S_loc) pair.  The buffer
    lies at the start of a host arena (``host``, pinned for a CUDA device;
    ``slot`` and ``turn`` of :class:`_HostArenas`): ``packed`` is a view of
    it, valid until the arena is taken again.  ``row_ids`` / ``blk_ids`` /
    ``out_keys`` keep the host copy of the global routing for emit.  Same
    plan pin as :class:`DenseChunk`."""

    plan: Any
    packed: np.ndarray  # flat int32 operand buffer (one transfer per chunk)
    n_items: int  # NI: bucketed item-column length
    n_events: int  # B: bucketed selected-event count
    n_rows: int  # S: bucketed routing length (per shard when sharded)
    k: int  # bucketed max items per selected event
    row_ids: np.ndarray
    blk_ids: np.ndarray
    out_keys: np.ndarray
    host: torch.Tensor  # the uint8 arena ``packed`` lies in
    slot: int
    turn: int
    shard_sel: Optional[List[np.ndarray]] = None
    n_shards: int = 1
    cold: Optional[List[ColdDense]] = None  # tier-miss columns, emitted after the rest

    def sizes(self) -> Dict[str, int]:
        """The packed sections' sizes, as :func:`~repro_torch.kernels.ops.
        dmm_apply_packed` takes them."""
        return dict(n_items=self.n_items, n_events=self.n_events, n_rows=self.n_rows,
                    k=self.k)


@dataclasses.dataclass
class DispatchHandle:
    """An in-flight dispatch: unsynchronised outputs and the dense chunk
    they came from."""

    outputs: Any
    dense: Any


@dataclasses.dataclass
class _ChunkLayout:
    """Selection + routing of one triaged chunk against one plan, shared by
    the host-densify and device-densify paths.  ``sel`` is the dense-row
    order (every mappable column's events, column by column)."""

    chunk: ColumnarChunk
    sel: np.ndarray  # (B,) i64: chunk event index per dense row
    ev_counts: np.ndarray  # (n_cols,) i64: dense rows per column
    col_ids: np.ndarray  # (n_cols,) i32: plan col_id per column
    row_ids: np.ndarray  # (S,) i32
    blk_ids: np.ndarray  # (S,) i32
    out_keys: np.ndarray  # (S,) i64


def _chunk_layout(
    plan: Any,
    tri: TriagedChunk,
    stats: Optional[collections.Counter] = None,
    uid_col: Optional[np.ndarray] = None,
) -> Optional[_ChunkLayout]:
    """Dense-row selection and (row, block) routing for a chunk, in the
    reference's emission order (per column, per block, per event); also
    accounts ``stats["unknown_uid"]`` against ``uid_col`` (the plan's own
    table unless given: with cold columns, the full lowering's).  None for
    an unmappable chunk."""
    chunk = tri.chunk
    if stats is not None:
        _count_unknown_uids(plan.uid_col if uid_col is None else uid_col, chunk,
                            tri.by_column, stats)
    cols = [
        (col, idx)
        for (o, v), idx in tri.by_column.items()
        if (col := plan.column(o, v)) is not None and col.block_ids.size
    ]
    if not cols:
        return None

    sel = np.concatenate([idx for _, idx in cols])
    ev_counts = np.asarray([idx.size for _, idx in cols], dtype=np.int64)
    col_ids = np.asarray([col.col_id for col, _ in cols], dtype=np.int32)

    # block t of a column owning n events yields the segment
    # arange(base, base + n); each column's blocks are the contiguous plan
    # range [start, start + count)
    bstart = plan.col_block_start[col_ids].astype(np.int64)
    bcount = plan.col_block_count[col_ids].astype(np.int64)
    seg_starts = np.repeat(_excl_cumsum(ev_counts), bcount)
    seg_counts = np.repeat(ev_counts, bcount)
    row_ids, seg_of = _segmented_arange(seg_starts, seg_counts)
    blk_seq, _ = _segmented_arange(bstart, bcount)

    return _ChunkLayout(
        chunk=chunk,
        sel=sel,
        ev_counts=ev_counts,
        col_ids=col_ids,
        row_ids=row_ids.astype(np.int32),
        blk_ids=blk_seq[seg_of].astype(np.int32),
        out_keys=chunk.keys[sel][row_ids],
    )


def _densify_host(
    plan: Any, layout: _ChunkLayout, arenas: "_HostArenas", rows: np.ndarray,
    blks: np.ndarray, shard_sel: Optional[List[np.ndarray]] = None,
) -> DenseChunk:
    """Host densification into a host arena taken from ``arenas``: the
    payload zeroed in place, then one CSR gather, one resolve through the
    plan's global uid tables (an item scatters only into its own column),
    one numpy scatter; and the padded (n_route, S) routing ``rows`` /
    ``blks`` beside it."""
    chunk, sel = layout.chunk, layout.sel
    shape = (bucket_rows(sel.size), plan.n_in_pad, *rows.shape)
    (_, _, rows_at, _), n_bytes = arena_layout(*shape)
    slot, turn, host = arenas.take(n_bytes)
    arena = host.numpy()[:n_bytes]
    arena[:rows_at] = 0  # the payload
    vals, mask, route_rows, route_blks = arena_views(arena, *shape)
    route_rows[...] = rows
    route_blks[...] = blks
    ev_rows, item_idx = _event_items(chunk, sel)
    if item_idx.size:
        uids = chunk.uids[item_idx]
        slots = _uid_slots(plan.uid_slot, uids)
        owner = _uid_slots(plan.uid_col, uids)
        keep = owner == np.repeat(layout.col_ids, layout.ev_counts)[ev_rows]
        if keep.any():
            r, c = ev_rows[keep], slots[keep]
            vals[r, c] = chunk.vals[item_idx[keep]]
            mask[r, c] = 1
    return DenseChunk(
        plan=plan,
        vals=vals,
        mask=mask,
        row_ids=layout.row_ids,
        blk_ids=layout.blk_ids,
        out_keys=layout.out_keys,
        rows=route_rows,
        blks=route_blks,
        host=host,
        slot=slot,
        turn=turn,
        shard_sel=shard_sel,
    )


def _pack_columnar(
    plan: Any, layout: _ChunkLayout, rows_flat: np.ndarray, blks_flat: np.ndarray,
    arenas: "_HostArenas", **routing: Any,
) -> ColumnarDense:
    """Pack one chunk's device-densify operands into ONE flat int32 buffer
    (the :class:`ColumnarDense` layout), byte-identical to the reference's,
    written straight into a host arena taken from ``arenas``.  ``routing``
    holds the routing fields of the :class:`ColumnarDense` (``n_rows``, and
    ``shard_sel`` / ``n_shards`` on the sharded path)."""
    chunk, sel = layout.chunk, layout.sel
    offs = chunk.event_offsets
    starts = offs[sel].astype(np.int32)
    counts = (offs[sel + 1] - offs[sel]).astype(np.int32)
    k = bucket_rows(int(counts.max(initial=1)))
    b = sel.size
    b_pad = bucket_rows(b)
    ni = chunk.n_items
    ni_pad = bucket_rows(ni)
    ev_col = np.repeat(layout.col_ids, layout.ev_counts)
    n = 2 * ni_pad + 3 * b_pad + rows_flat.size + blks_flat.size
    slot, turn, host = arenas.take(4 * n)
    p = host.numpy()[: 4 * n].view(np.int32)
    # a uid beyond int32 would wrap on the cast and could alias a real uid;
    # it is unknown by definition, so it becomes the -1 sentinel
    uids = chunk.uids
    p[:ni] = np.where((uids >= 0) & (uids < np.int64(2**31)), uids, -1)
    p[ni:ni_pad] = -1  # padded items: unknown uid, never scatters
    p[ni_pad : ni_pad + ni] = chunk.vals.view(np.int32)
    p[ni_pad + ni : 2 * ni_pad] = 0
    o = 2 * ni_pad
    for arr, fill in ((starts, 0), (counts, 0), (ev_col, -1)):
        p[o : o + b] = arr
        p[o + b : o + b_pad] = fill  # padded events: 0 items, no column
        o += b_pad
    p[o : o + rows_flat.size] = rows_flat
    o += rows_flat.size
    p[o : o + blks_flat.size] = blks_flat
    return ColumnarDense(
        plan=plan, packed=p, n_items=ni_pad, n_events=b_pad, k=k,
        row_ids=layout.row_ids, blk_ids=layout.blk_ids, out_keys=layout.out_keys,
        host=host, slot=slot, turn=turn, **routing,
    )


def densify_chunk_dicts(plan: Any, groups: Groups) -> Optional[DenseChunk]:
    """The pre-columnar densification: one python pass over every payload
    dict item, resolved through each column's ``uid_pos`` dict.

    Kept (not routed in production) as the bit-exactness oracle for the
    columnar densify; accepts only the legacy ``Groups`` form.
    """
    cols = [
        (col, evs)
        for (o, v), evs in groups.items()
        if (col := plan.column(o, v)) is not None and col.block_ids.size
    ]
    if not cols:
        return None

    n_events = sum(len(evs) for _, evs in cols)
    vals = np.zeros((bucket_rows(n_events), plan.n_in_pad), np.float32)
    mask = np.zeros_like(vals, dtype=np.int8)
    row_parts: List[np.ndarray] = []
    blk_parts: List[np.ndarray] = []
    out_keys: List[int] = []
    base = 0
    for col, evs in cols:
        lookup = col.uid_pos
        r_idx: List[int] = []
        c_idx: List[int] = []
        v_buf: List[float] = []
        for b, ev in enumerate(evs):
            for uid, val in ev.payload().items():
                if val is None:
                    continue
                pos = lookup.get(uid)
                if pos is not None:
                    r_idx.append(base + b)
                    c_idx.append(pos)
                    v_buf.append(val)
        if r_idx:
            vals[r_idx, c_idx] = v_buf
            mask[r_idx, c_idx] = 1
        ev_rows = np.arange(base, base + len(evs), dtype=np.int32)
        for t in col.block_ids:
            row_parts.append(ev_rows)
            blk_parts.append(np.full(len(evs), t, np.int32))
            out_keys.extend(ev.key for ev in evs)
        base += len(evs)

    return DenseChunk(
        plan=plan,
        vals=vals,
        mask=mask,
        row_ids=np.concatenate(row_parts),
        blk_ids=np.concatenate(blk_parts),
        out_keys=np.asarray(out_keys, dtype=np.int64),
    )


def _densify_cold(
    lease: Optional[PlanEpoch], tri: TriagedChunk, stats: collections.Counter
) -> Optional[List[ColdDense]]:
    """Densify the chunk's events of the lease's cold columns at each
    column's true width: the columnar scatter of the resident path, counted
    per event under ``stats["tier_misses"]``.  None when the chunk touches
    no cold column (always, without tiering)."""
    if lease is None or not lease.cold:
        return None
    chunk = tri.chunk
    out: List[ColdDense] = []
    for ov, idx in tri.by_column.items():
        col = lease.cold.get(ov)
        if col is None:
            continue
        vals = np.zeros((idx.size, col.n_in), np.float32)
        mask = np.zeros((idx.size, col.n_in), np.int8)
        ev_rows, item_idx = _event_items(chunk, idx)
        if item_idx.size:
            slots = _uid_slots(col.lut, chunk.uids[item_idx])
            keep = slots >= 0
            if keep.any():
                vals[ev_rows[keep], slots[keep]] = chunk.vals[item_idx[keep]]
                mask[ev_rows[keep], slots[keep]] = 1
        stats["tier_misses"] += int(idx.size)
        out.append(ColdDense(col=col, keys=chunk.keys[idx], vals=vals, mask=mask))
    return out or None


def _cold_only_chunk(plan: Any, cold: List[ColdDense]) -> DenseChunk:
    """A chunk whose every mappable column is cold: no resident routing and
    no host arena, so dispatch launches nothing; its rows come from the
    cold path alone."""
    return DenseChunk(
        plan=plan,
        vals=np.zeros((0, 0), np.float32),
        mask=np.zeros((0, 0), np.int8),
        row_ids=np.empty(0, np.int32),
        blk_ids=np.empty(0, np.int32),
        out_keys=np.empty(0, np.int64),
        cold=cold,
    )


def _emit_cold(
    cold: Optional[List[ColdDense]], stats: collections.Counter, device: torch.device
) -> List[CanonicalRow]:
    """Map a chunk's tier-miss columns on ``device``: per column one copy
    each of its values, mask and concatenated index vectors, then per block
    one :func:`~repro_torch.kernels.ops.dmm_apply` (``masked_gather``: the
    kernel on a card, its plain version on the CPU) and one readback of its
    outputs.  Rows follow the resident rows, per column, per block, per
    event, as in the reference; ``stats`` counts 2 transfers a column and
    no dispatch, as the reference does, while the kernel's ``launches``
    and ``ops.dispatch_count`` count the launches."""
    rows: List[CanonicalRow] = []
    if not cold:
        return rows
    for cd in cold:
        stats["transfers"] += 2  # the reference counts values + mask
        vals = torch.from_numpy(cd.vals).to(device)
        mask = torch.from_numpy(cd.mask).to(device)
        src_flat = torch.from_numpy(cd.col.src_flat).to(device)
        outs, off = [], 0
        for block in cd.col.blocks:
            outs.append(dmm_apply(vals, mask, src_flat[off : off + block.n_out_pad]))
            off += block.n_out_pad
        keys = cd.keys.tolist()
        for block, (ov, om) in zip(cd.col.blocks, outs):
            # the documented slow path: read back block by block, into
            # memory the rows own
            ov, om = ov.cpu().numpy(), om.cpu().numpy()
            route, live = (block.key[2], block.key[3]), om.any(axis=1)
            for b, key in enumerate(keys):
                if live[b]:  # only non-empty outgoing messages
                    rows.append((route, ov[b, : block.n_out], om[b, : block.n_out], key))
                    stats["mapped"] += 1
                else:
                    stats["empty"] += 1
    return rows


def _emit_shards(dense, ov, om, stats) -> List[CanonicalRow]:
    """The sharded engine's all-gather on the host: every shard's (n_shards,
    S_loc, W) rows, each global output row i taken from its shard's slot
    (flat index shard * S_loc + k), then emitted as the fused engine emits;
    the fancy index copies, so the rows own their memory."""
    n_sh, s_loc, w = ov.shape
    flat = np.empty(dense.row_ids.size, np.int64)
    for s, idx in enumerate(dense.shard_sel):
        flat[idx] = s * s_loc + np.arange(idx.size)
    return _emit_rows(
        dense.plan, ov.reshape(n_sh * s_loc, w)[flat], om.reshape(n_sh * s_loc, w)[flat],
        dense.blk_ids, dense.out_keys, stats,
    )


def _emit_rows(plan, ov, om, blk_ids, out_keys, stats) -> List[CanonicalRow]:
    """Row emission: one ``any``/``nonzero`` over the output mask, then
    slice each surviving row to its block's true width."""
    rows: List[CanonicalRow] = []
    emit = np.nonzero(om.any(axis=1))[0]  # only non-empty outgoing messages
    stats["mapped"] += int(emit.size)
    stats["empty"] += int(blk_ids.size - emit.size)
    routes, n_out = plan.routes, plan.n_out
    widths = n_out[blk_ids[emit]].tolist()
    for i, t, no, key in zip(
        emit.tolist(), blk_ids[emit].tolist(), widths, out_keys[emit].tolist()
    ):
        rows.append((routes[t], ov[i, :no], om[i, :no], key))
    return rows


class MappingEngine:
    """Protocol base for mapping engines.

    Subclasses declare their ``plan_kind`` and implement the three chunk
    stages (``densify`` / ``dispatch`` / ``emit``) plus ``info``;
    ``compile`` ACQUIRES the plan from the engine's
    :class:`~repro_torch.etl.plan.PlanManager` (its own, on the engine's
    device, unless one is passed; a manager of another kind or device
    raises).  ``stats`` is the counter the owning METL app injects.
    """

    name: str = "base"
    plan_kind: str = "fused"  # the PlanManager kind this engine consumes
    impl: str = "gather"  # the mapping algorithm (only the blocks engine varies it)
    n_shards: int = 1  # block-table shards (only the sharded engine has more)

    def __init__(
        self,
        *,
        device: DeviceLike = "cuda",
        stats: Optional[collections.Counter] = None,
        manager: Optional[PlanManager] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else collections.Counter()
        if manager is None:
            manager = PlanManager(kind=self.plan_kind, device=self.device)
        if manager.kind != self.plan_kind:
            raise ValueError(
                f"engine {self.name!r} consumes plan kind {self.plan_kind!r}, "
                f"manager builds {manager.kind!r}"
            )
        if manager.device != self.device:
            raise ValueError(
                f"manager builds on {manager.device}, engine runs on {self.device}"
            )
        self.manager = manager
        self.plan: Any = None
        self.lease: Optional[PlanEpoch] = None
        # observability binding (set by METLApp): the coordinator whose
        # replication surface info() reports
        self.coordinator: Optional[Any] = None
        # uid -> owning column over every column when the lease has cold
        # ones (the resident plan's table covers the hot columns only)
        self._stats_uid_col: Optional[np.ndarray] = None

    @property
    def ready(self) -> bool:
        return self.plan is not None

    def compile(self, snapshot: SystemState, registry: Registry) -> Any:
        """Acquire (and retain) the device plan for one state snapshot:
        cached when current, spliced when the DPM diff allows, rebuilt
        otherwise."""
        self.lease = self.manager.acquire(snapshot, registry)
        self.plan = self.lease.plan
        self._on_plan(self.lease, registry)
        return self.plan

    def evict(self) -> None:
        """Drop every state-derived cache; the manager keeps its state-keyed
        lease, so a re-acquire at an unchanged state is a cache hit."""
        self.plan = None
        self.lease = None
        self._stats_uid_col = None

    def _on_plan(self, lease: PlanEpoch, registry: Registry) -> None:
        """Refresh what the engine derives from a new lease: with cold
        columns, ``stats["unknown_uid"]`` keeps counting against every
        column, as in the reference."""
        self._stats_uid_col = (global_uid_tables(lease.compiled, registry)[1]
                               if lease.cold else None)

    def _manager_info(self) -> Dict[str, Any]:
        """The manager- and coordinator-derived keys of ``info()``."""
        mi = self.manager.info()
        m: Dict[str, Any] = {"plan_epoch": mi["plan_epoch"], "rebuilds": mi["rebuilds"]}
        if self.coordinator is not None:
            m.update(self.coordinator.replication_info())
        else:
            m.update(role="unbound", term=0, log_offset=0, lag_records=0)
        return m

    def densify(self, groups: Groups) -> Any:
        """Host-side densification; returns a dense chunk or None when the
        chunk touches no mapping path."""
        raise NotImplementedError

    def dispatch(self, dense: Any) -> DispatchHandle:
        """Launch the device work for one dense chunk WITHOUT synchronising;
        increments ``stats['dispatches']`` once per launch."""
        raise NotImplementedError

    def emit(self, handle: DispatchHandle) -> List[CanonicalRow]:
        """Synchronise on a dispatch handle and emit canonical rows."""
        raise NotImplementedError

    def consume_groups(self, groups: Groups) -> List[CanonicalRow]:
        """Synchronous densify -> dispatch -> emit of one triaged chunk."""
        dense = self.densify(groups)
        if dense is None:
            return []
        return self.emit(self.dispatch(dense))

    def info(self) -> Dict[str, Any]:
        """Public observability surface.  Keys (every engine): ``engine``,
        ``impl``, ``device``, ``n_shards``, ``device_densify``,
        ``dispatches``, ``transfers``, ``plan_epoch``, ``rebuilds``,
        ``role``, ``term``, ``log_offset``, ``lag_records``; once a plan is
        compiled also ``state``, ``n_blocks``, ``blocks_per_shard``,
        ``table_bytes``, ``table_bytes_per_shard``, ``bytes_resident`` and,
        for the fused engine, ``width``."""
        raise NotImplementedError

    def _base_info(self) -> Dict[str, Any]:
        """The keys of ``info()`` every engine carries."""
        return {
            "engine": self.name,
            "impl": self.impl,
            "device": str(self.device),
            "n_shards": self.n_shards,
            "device_densify": bool(getattr(self, "device_densify", False)),
            "dispatches": int(self.stats["dispatches"]),
            "transfers": int(self.stats["transfers"]),
            **self._manager_info(),
        }


# -- engine registry ---------------------------------------------------------

ENGINES: Dict[str, Type[MappingEngine]] = {}


def register_engine(name: str) -> Any:
    """Class decorator: register a :class:`MappingEngine` under ``name`` so
    ``METLApp(..., engine=name)`` resolves it through :func:`make_engine`."""

    def deco(cls: Type[MappingEngine]) -> Type[MappingEngine]:
        cls.name = name
        ENGINES[name] = cls
        return cls

    return deco


def make_engine(
    engine: Any = "fused",
    *,
    impl: str = "gather",
    device: Optional[DeviceLike] = None,
    mesh: Any = None,
    device_densify: bool = False,
    stats: Optional[collections.Counter] = None,
    manager: Optional[PlanManager] = None,
) -> MappingEngine:
    """Resolve a registered engine name, or adopt an instance.

    Routing rules, as in the reference:

      * ``impl="onehot"`` only exists as a per-block kernel, so with
        ``engine="fused"`` or ``"sharded"`` it routes to the ``blocks``
        engine rather than silently changing the benched path;
      * ``engine="sharded"`` needs more than one shard on ``mesh``
        (:func:`repro_torch.launch.mesh.make_etl_mesh`); with one shard or
        no mesh it is the fused engine;
      * ``device_densify=True`` is realised by the fused and sharded engines
        only, so it raises with ``impl="onehot"`` or ``engine="blocks"``.

    ``impl`` is ``"gather"`` or ``"onehot"``; anything else raises.
    ``device`` defaults to the mesh's first device when a mesh is given,
    else to ``manager``'s device, else to ``"cuda"`` for a name and to the
    instance's own device for an instance; a mesh on another device than
    ``device``, and a conflicting ``impl``, ``device``, ``mesh`` or
    ``device_densify``, raise instead of running a different path than
    asked.  ``manager`` binds an explicit
    :class:`~repro_torch.etl.plan.PlanManager` (tiering, a background
    build, published epochs); a manager of another kind, device or mesh
    than the engine the rules resolve to raises.  Without one the engine
    builds its own, incremental as in the reference.
    """
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.devices[0]:
            raise ValueError(
                f"device={device!r} conflicts with the mesh, whose first shard "
                f"is on {mesh.devices[0]}"
            )
        device = mesh.devices[0]
    if isinstance(engine, MappingEngine):
        if mesh is not None and getattr(engine, "mesh", None) is not mesh:
            raise ValueError(
                "mesh= conflicts with the engine instance; construct the "
                "engine with its mesh instead"
            )
        if impl != "gather" and impl != engine.impl:
            raise ValueError(
                f"impl={impl!r} conflicts with engine instance impl="
                f"{engine.impl!r}; configure the instance instead"
            )
        if device is not None and resolve_device(device) != engine.device:
            raise ValueError(
                f"device={device!r} conflicts with the engine instance's "
                f"device {engine.device}"
            )
        if device_densify and not getattr(engine, "device_densify", False):
            raise ValueError(
                "device_densify=True conflicts with the engine instance; "
                "construct the engine with device_densify=True instead"
            )
        if stats is not None:
            engine.stats = stats
        if manager is not None and engine.manager is not manager:
            raise ValueError(
                "manager= conflicts with the engine instance's manager; construct "
                "the engine with its manager instead"
            )
        return engine
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (registered: {sorted(ENGINES)})")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (ported: {IMPLS})")
    if device is None:
        device = "cuda" if manager is None else manager.device
    if impl == "onehot" and engine in ("fused", "sharded"):
        if device_densify:
            raise ValueError(
                "device_densify=True has no onehot realisation (impl='onehot' "
                "routes to the per-block engine)"
            )
        engine = "blocks"
    if engine == "sharded":
        if mesh is not None and mesh.shape["data"] > 1:
            return ENGINES["sharded"](mesh=mesh, device_densify=device_densify, stats=stats,
                                      manager=manager)
        engine = "fused"
    if engine == "fused":
        return ENGINES["fused"](device=device, device_densify=device_densify, stats=stats,
                                manager=manager)
    if device_densify:
        raise ValueError(
            f"engine={engine!r} has no device-densify path (fused/sharded only)"
        )
    return ENGINES[engine](impl=impl, device=device, stats=stats, manager=manager)


@register_engine("fused")
class FusedEngine(MappingEngine):
    """One fused dispatch for the whole chunk (all columns, all blocks).

    By default densify scatters the chunk's payload into a host arena and
    dispatch makes one :func:`~repro_torch.kernels.ops.dmm_apply_dense`
    call (values, mask, rows, blks: four transfers, one dispatch).  With
    ``device_densify=True`` densify packs the chunk's raw items and routing
    into ONE int32 buffer and dispatch resolves, densifies and maps them in
    the one launch -- one transfer and one dispatch per chunk.  Chunks below
    ``min_device_events`` selected events take the host scatter, as in the
    reference.  Emit reads the chunk's outputs back with one copy, then maps
    the chunk's cold columns, if the lease has any (:func:`_emit_cold`); a
    chunk whose columns are all cold launches nothing resident.
    """

    def __init__(
        self,
        *,
        device: DeviceLike = "cuda",
        device_densify: bool = False,
        min_device_events: int = 32,
        stats: Optional[collections.Counter] = None,
        manager: Optional[PlanManager] = None,
    ) -> None:
        super().__init__(device=device, stats=stats, manager=manager)
        self.device_densify = device_densify
        self.min_device_events = min_device_events
        self._arenas = _HostArenas(self.device)
        self._readback = _ReadBack()

    def densify(self, groups: Groups) -> Any:
        tri = as_triaged(groups)
        if tri is None:
            return None
        layout = _chunk_layout(self.plan, tri, self.stats, self._stats_uid_col)
        cold = _densify_cold(self.lease, tri, self.stats)
        if layout is None:
            return _cold_only_chunk(self.plan, cold) if cold else None
        s = layout.row_ids.size
        rows = np.zeros((1, bucket_rows(s)), np.int32)
        blks = np.zeros_like(rows)
        rows[0, :s] = layout.row_ids
        blks[0, :s] = layout.blk_ids
        if not self.device_densify or layout.sel.size < self.min_device_events:
            dense = _densify_host(self.plan, layout, self._arenas, rows, blks)
        else:
            dense = _pack_columnar(self.plan, layout, rows[0], blks[0], self._arenas,
                                   n_rows=rows.shape[1])
        dense.cold = cold
        return dense

    def dispatch(self, dense) -> DispatchHandle:
        if dense.row_ids.size == 0:  # a cold-only chunk: nothing resident
            return DispatchHandle(outputs=None, dense=dense)
        fused = dense.plan
        if isinstance(dense, ColumnarDense):
            return _dispatch(self._arenas, self.stats, dense, dmm_apply_packed,
                             fused.uid_slot_dev, fused.uid_col_dev, fused.src2d,
                             **dense.sizes())
        return _dispatch(self._arenas, self.stats, dense, dmm_apply_dense, fused.src2d,
                         **dense.sizes())

    def emit(self, handle: DispatchHandle) -> List[CanonicalRow]:
        dense = handle.dense
        rows: List[CanonicalRow] = []
        if handle.outputs is not None:
            s = dense.row_ids.size
            vals, mask = self._readback.read(handle.outputs)
            ov, om = vals[0, :s].copy(), mask[0, :s].copy()  # rows own their memory
            rows = _emit_rows(dense.plan, ov, om, dense.blk_ids, dense.out_keys, self.stats)
        rows.extend(_emit_cold(dense.cold, self.stats, self.device))
        return rows

    def info(self) -> Dict[str, Any]:
        d = self._base_info()
        if self.lease is not None:
            p = self.lease.plan
            table_bytes = int(p.src2d.nbytes)
            d.update(
                state=p.state,
                n_blocks=p.n_blocks,
                blocks_per_shard=p.n_blocks,
                width=p.width,
                table_bytes=table_bytes,
                table_bytes_per_shard=table_bytes,
                bytes_resident=self.lease.bytes_resident,
            )
        return d


# -- the sharded engine --------------------------------------------------------


@register_engine("sharded")
class ShardedEngine(MappingEngine):
    """The fused path with the block table sharded over a mesh's shards
    (:class:`~repro_torch.launch.mesh.ETLMesh`, shard ``s`` on
    ``mesh.devices[s]``).

    ``densify`` splits the global (row, block) routing by owning shard (host
    work) and writes the chunk into a host arena; ``dispatch`` is one op
    call a chunk, which launches ``segmented_gather_shard`` (host densify,
    4 transfers) or ``densify_map_shard`` (device densify, 1 transfer) once
    per device of the mesh -- once a chunk when every shard is on one card;
    ``emit``, the one sync point, is the all-gather: it reads every shard's
    rows back to the host with one copy, puts them in global order and
    emits them as the fused engine does, so the rows are bit-exact with it.
    Chunks below ``min_device_events`` selected events take host densify,
    as in the reference.  Cold columns are mapped after the resident rows on
    the mesh's first device, where the engine runs, as the fused engine maps
    them.
    """

    plan_kind = "sharded"

    def __init__(
        self,
        *,
        mesh: Any,
        device_densify: bool = False,
        min_device_events: int = 32,
        stats: Optional[collections.Counter] = None,
        manager: Optional[PlanManager] = None,
    ) -> None:
        if mesh is None:
            raise ValueError("engine='sharded' needs a mesh (make_etl_mesh)")
        if manager is None:
            manager = PlanManager(kind=self.plan_kind, mesh=mesh)
        elif manager.mesh is not mesh:
            raise ValueError("the manager builds for another mesh than the engine's")
        super().__init__(device=mesh.devices[0], stats=stats, manager=manager)
        self.mesh = mesh
        self.n_shards = int(mesh.shape["data"])
        self.device_densify = device_densify
        self.min_device_events = min_device_events
        self._arenas = _HostArenas(self.device)
        self._readback = _ReadBack()

    def _shard_split(
        self, row_ids: np.ndarray, blk_ids: np.ndarray
    ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
        """Split the global (row, block) routing by owning shard; the
        contiguous block partition makes ownership a divide, and each
        shard's selection keeps global order for the scatter-back.  Pad
        entries route to event row 0 through local block 0 and are never
        emitted."""
        sh = self.plan
        per = sh.blocks_per_shard
        owner = blk_ids // per
        sel = [np.flatnonzero(owner == s) for s in range(sh.n_shards)]
        s_pad = bucket_rows(max(idx.size for idx in sel))
        rows_sh = np.zeros((sh.n_shards, s_pad), np.int32)
        blks_sh = np.zeros((sh.n_shards, s_pad), np.int32)
        for s, idx in enumerate(sel):
            rows_sh[s, : idx.size] = row_ids[idx]
            blks_sh[s, : idx.size] = blk_ids[idx] - s * per
        return sel, rows_sh, blks_sh

    def densify(self, groups: Groups) -> Any:
        tri = as_triaged(groups)
        if tri is None:
            return None
        layout = _chunk_layout(self.plan, tri, self.stats, self._stats_uid_col)
        cold = _densify_cold(self.lease, tri, self.stats)
        if layout is None:
            return _cold_only_chunk(self.plan, cold) if cold else None
        sel, rows_sh, blks_sh = self._shard_split(layout.row_ids, layout.blk_ids)
        if not self.device_densify or layout.sel.size < self.min_device_events:
            dense = _densify_host(self.plan, layout, self._arenas, rows_sh, blks_sh, sel)
        else:
            dense = _pack_columnar(self.plan, layout, rows_sh.ravel(), blks_sh.ravel(),
                                   self._arenas, n_rows=rows_sh.shape[1], shard_sel=sel,
                                   n_shards=self.n_shards)
        dense.cold = cold
        return dense

    def dispatch(self, dense) -> DispatchHandle:
        if dense.row_ids.size == 0:  # a cold-only chunk: nothing resident
            return DispatchHandle(outputs=None, dense=dense)
        sh = dense.plan
        if isinstance(dense, ColumnarDense):
            return _dispatch(self._arenas, self.stats, dense, dmm_apply_packed,
                             sh.uid_slot_dev, sh.uid_col_dev, sh.src3d, mesh=self.mesh,
                             n_shards=dense.n_shards, **dense.sizes())
        return _dispatch(self._arenas, self.stats, dense, dmm_apply_dense, sh.src3d,
                         mesh=self.mesh, n_shards=dense.rows.shape[0], **dense.sizes())

    def emit(self, handle: DispatchHandle) -> List[CanonicalRow]:
        dense = handle.dense
        rows: List[CanonicalRow] = []
        if handle.outputs is not None:
            rows = _emit_shards(dense, *self._readback.read(handle.outputs), self.stats)
        rows.extend(_emit_cold(dense.cold, self.stats, self.device))
        return rows

    def info(self) -> Dict[str, Any]:
        d = self._base_info()
        if self.lease is not None:
            p = self.lease.plan
            d.update(
                state=p.state,
                n_blocks=p.n_blocks,
                blocks_per_shard=p.blocks_per_shard,
                width=p.width,
                table_bytes=p.table_bytes,
                table_bytes_per_shard=p.table_bytes_per_shard,
                bytes_resident=self.lease.bytes_resident,
            )
        return d


# -- the per-block engine ------------------------------------------------------


_ARENA_MIN = 1 << 16  # bytes of a host arena when first allocated


def _grown(buf: Optional[torch.Tensor], n_bytes: int, pin: bool) -> torch.Tensor:
    """``buf``, or a new buffer twice as large (repeatedly) when it holds
    fewer than ``n_bytes``."""
    size = _ARENA_MIN if buf is None else buf.numel()
    while size < n_bytes:
        size *= 2
    if buf is None or size > buf.numel():
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
    return buf


class _HostArenas:
    """An engine's host arenas: two, taken in turn by ``densify``.

    A chunk's copies read its arena asynchronously, so ``dispatch`` records
    a CUDA event after issuing them (:meth:`release`) and :meth:`take` waits
    on the event of the slot it hands out before the arena is overwritten:
    whether or not the chunk was emitted.  A chunk densified into a slot that
    was taken again before it was dispatched cannot be dispatched
    (:meth:`check`).  Arenas grow by doubling and never shrink; on a CUDA
    device they are pinned."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.pin = device.type == "cuda"
        self.bufs: List[Optional[torch.Tensor]] = [None, None]
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turns = [0, 0]
        self.next = 0

    def take(self, n_bytes: int) -> Tuple[int, int, torch.Tensor]:
        """``(slot, turn, arena)`` of at least ``n_bytes``."""
        i, self.next = self.next, self.next ^ 1
        if self.events[i] is not None:
            self.events[i].synchronize()  # the copies that read it have run
            self.events[i] = None
        buf = self.bufs[i] = _grown(self.bufs[i], n_bytes, self.pin)
        self.turns[i] += 1
        return i, self.turns[i], buf

    def check(self, slot: int, turn: int) -> None:
        if self.turns[slot] != turn:
            raise RuntimeError("this chunk's host arena was taken by a later densify "
                               "before the chunk was dispatched")

    def release(self, slot: int) -> None:
        """Mark the copies just issued from ``slot``'s arena (CUDA only)."""
        if self.pin:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.events[slot] = ev


class _ReadBack:
    """The fused and sharded engines' emit: a chunk's outputs back to the
    host with one copy into a pinned buffer and one wait.  The buffer grows
    by doubling and is rewritten by the next emit, so the caller copies what
    it keeps.  On the CPU the outputs are read where they lie."""

    def __init__(self) -> None:
        self.buf: Optional[torch.Tensor] = None

    def read(self, out: ChunkOutput) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk's (n_shards, S, W) values and mask as numpy arrays."""
        n = 5 * out.shape[0] * out.shape[1] * out.shape[2]
        raw = out.buf[:n]
        if raw.device.type != "cpu":
            self.buf = _grown(self.buf, n, True)
            host = self.buf[:n]
            host.copy_(raw)  # one copy, then a wait for it (and so for the kernel)
            raw = host
        return split_outputs(raw.numpy(), *out.shape)


def _dispatch(arenas: _HostArenas, stats: collections.Counter, dense, op, *args: Any,
              **kwargs: Any) -> DispatchHandle:
    """The fused and sharded engines' dispatch: one ``op`` call
    (:func:`~repro_torch.kernels.ops.dmm_apply_dense` or
    :func:`~repro_torch.kernels.ops.dmm_apply_packed`) from the chunk's
    host arena, then the event that frees the arena; ``stats`` counts the
    copies and dispatches the call reports."""
    arenas.check(dense.slot, dense.turn)
    try:
        out = op(dense.host, *args, **kwargs)
    finally:
        arenas.release(dense.slot)
    stats["transfers"] += out.copies
    stats["dispatches"] += out.dispatches
    return DispatchHandle(outputs=out, dense=dense)


@dataclasses.dataclass
class _BlockTable:
    """A placed per-block plan as arrays, blocks in ``src_flat`` order: each
    column's contiguous block range, and per block its index vector's offset
    in ``src_flat``, its padded and true output widths and its route."""

    col_range: Dict[Tuple[int, int], Tuple[int, int]]  # (o, v) -> (first block, count)
    src_off: np.ndarray  # int64 (n_blocks,)
    n_out_pad: np.ndarray  # int64 (n_blocks,)
    n_out: List[int]
    routes: List[Tuple[int, int]]

    @classmethod
    def of(cls, plan: CompiledDMM) -> "_BlockTable":
        blocks = [b for col in plan.by_column.values() for b in col]
        base = plan.src_flat.storage_offset()
        col_range, first = {}, 0
        for ov, col in plan.by_column.items():
            col_range[ov] = (first, len(col))
            first += len(col)
        return cls(
            col_range=col_range,
            src_off=np.asarray([b.src_dev.storage_offset() - base for b in blocks],
                               dtype=np.int64),
            n_out_pad=np.asarray([b.n_out_pad for b in blocks], dtype=np.int64),
            n_out=[b.n_out for b in blocks],
            routes=[(b.key[2], b.key[3]) for b in blocks],
        )


class _ColumnSlots:
    """uid -> payload slot of every (schema, version) column seen: each
    column's :func:`~repro_torch.core.dmm_torch.uid_lookup_table`, laid end
    to end in ``flat`` (column id c's from ``base[c]``, ``size[c]`` long),
    so a chunk's items resolve in one bounds-checked gather."""

    def __init__(self, registry: Registry, table: _BlockTable) -> None:
        self.registry = registry
        self.table = table
        self.ids: Dict[Tuple[int, int], int] = {}
        # per column id: (N_in, LUT base, LUT size, first block, block count)
        self.rows: List[Tuple[int, int, int, int, int]] = []
        self.flat = np.empty(0, dtype=np.int32)
        self.columns(list(table.col_range))

    def columns(self, ovs) -> np.ndarray:
        """Column ids of ``ovs``, registering those not seen yet."""
        new = [ov for ov in dict.fromkeys(ovs) if ov not in self.ids]
        if new:
            luts, base = [self.flat], self.flat.size
            for ov in new:
                uids = self.registry.domain.get(*ov).uids
                luts.append(uid_lookup_table(uids))
                self.ids[ov] = len(self.rows)
                self.rows.append((len(uids), base, luts[-1].size,
                                  *self.table.col_range.get(ov, (0, 0))))
                base += luts[-1].size
            self.flat = np.concatenate(luts)
            (self.n_in, self.base, self.size, self.block_first,
             self.block_count) = np.asarray(self.rows, dtype=np.int64).reshape(-1, 5).T.copy()
        return np.fromiter((self.ids[ov] for ov in ovs), dtype=np.int64, count=len(ovs))

    def lookup(self, cids: np.ndarray, uids: np.ndarray) -> np.ndarray:
        """Payload slot of each (column id, uid), -1 where the column does
        not list the uid."""
        valid = (uids >= 0) & (uids < self.size[cids])
        slots = self.flat[np.where(valid, self.base[cids] + uids, 0)] if self.flat.size else -1
        return np.where(valid, slots, -1)


@dataclasses.dataclass
class BlockDense:
    """One chunk densified for the per-block engine, pinned to the placed
    per-block plan it was densified against: its payloads in a host arena
    and its descriptors (``chunk``, a
    :class:`~repro_torch.kernels.blocks.BlockChunk`); the (schema, version)
    column of each group; the event key of each dense row, group by group
    (``keys``, group g's rows from ``key_start[g]``); the global plan id of
    each block (its route and true width in ``table``); and the arena slot
    and turn it was densified into."""

    plan: CompiledDMM
    chunk: BlockChunk
    columns: List[Tuple[int, int]]
    keys: np.ndarray  # int64 (rows,)
    key_start: np.ndarray  # int64 (G,)
    block_ids: np.ndarray  # int64 (K,)
    table: _BlockTable
    slot: int
    turn: int

    def payload(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """Group ``g``'s (B, N_in) values and mask: views of the host arena,
        valid until the arena is taken again."""
        return self.chunk.payload(g)


@register_engine("blocks")
class BlocksEngine(MappingEngine):
    """One device dispatch per compacted block of each (o, v) group -- the
    paper's per-block mapping, kept for the A/B against the fused engine
    and as the only realisation of ``impl="onehot"``.

    ``densify`` scatters every group's payload, at the column's true width,
    into one host arena (16-byte aligned, zeroed first) and describes the
    chunk's groups and blocks in two int64 tables, all vectorised over the
    chunk (shared :func:`_event_items`).  ``dispatch`` is one
    :func:`~repro_torch.kernels.ops.dmm_apply_blocks` call: per group 2
    transfers (values, mask), per block one dispatch against the block
    index vectors the plan keeps resident on the device, counted from what
    the launcher reports.  ``emit`` reads the two output arenas back with
    one copy each.  Host arenas are reused in turn (:class:`_HostArenas`).
    """

    plan_kind = "blocks"

    def __init__(
        self,
        *,
        impl: str = "gather",
        device: DeviceLike = "cuda",
        stats: Optional[collections.Counter] = None,
        manager: Optional[PlanManager] = None,
    ) -> None:
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r} (ported: {IMPLS})")
        super().__init__(device=device, stats=stats, manager=manager)
        self.impl = impl
        self._cols: Optional[_ColumnSlots] = None
        self._uid_col_global: Optional[np.ndarray] = None
        self._arenas = _HostArenas(self.device)

    def _on_plan(self, lease: PlanEpoch, registry: Registry) -> None:
        super()._on_plan(lease, registry)
        # uid -> slot tables are per registry state
        self._cols = _ColumnSlots(registry, _BlockTable.of(lease.plan))
        # plan-global uid -> owning-column table, so stats["unknown_uid"] is
        # counted as the fused engine counts it
        self._uid_col_global = global_uid_tables(lease.compiled, registry)[1]

    def densify(self, groups) -> Optional[BlockDense]:
        tri = as_triaged(groups)
        if tri is None:
            return None
        chunk, cols = tri.chunk, self._cols
        if chunk.vals.dtype != np.float32:
            raise TypeError(f"the per-block engine takes a float32 payload, not "
                            f"{chunk.vals.dtype}")
        _count_unknown_uids(self._uid_col_global, chunk, tri.by_column, self.stats)
        columns = list(tri.by_column)
        idxs = [np.asarray(i, dtype=np.int64) for i in tri.by_column.values()]
        cid = cols.columns(columns)
        rows = np.fromiter((i.size for i in idxs), dtype=np.int64, count=len(idxs))
        n_in = cols.n_in[cid]
        # each group's blocks: the column's contiguous range of the plan
        block_ids, bgroup = _segmented_arange(cols.block_first[cid], cols.block_count[cid])
        table = cols.table
        groups, blocks, n_bytes, n_out = BlockChunk.layout(
            rows, n_in, bgroup, table.src_off[block_ids], table.n_out_pad[block_ids])
        slot, turn, host = self._arenas.take(n_bytes)
        host[:n_bytes].zero_()
        descr = BlockChunk(host, groups, blocks, n_bytes, n_out)
        sel = np.concatenate(idxs)
        key_start = _excl_cumsum(rows)
        ev_rows, item_idx = _event_items(chunk, sel)
        if item_idx.size:
            g = np.repeat(np.arange(rows.size, dtype=np.int64), rows)[ev_rows]
            slots = cols.lookup(cid[g], chunk.uids[item_idx])
            keep = slots >= 0
            if keep.any():
                g = g[keep]
                elem = (ev_rows[keep] - key_start[g]) * n_in[g] + slots[keep]
                descr.scatter(g, elem, chunk.vals[item_idx[keep]])
        return BlockDense(plan=self.plan, chunk=descr, columns=columns,
                          keys=chunk.keys[sel], key_start=key_start,
                          block_ids=block_ids, table=table, slot=slot, turn=turn)

    def dispatch(self, dense: BlockDense) -> DispatchHandle:
        self._arenas.check(dense.slot, dense.turn)
        out_v, out_m, copies, launches = dmm_apply_blocks(
            dense.chunk, dense.plan.src_flat, impl=self.impl)
        self._arenas.release(dense.slot)
        # as the reference counts: 2 per group (vals + mask), 1 per block
        self.stats["transfers"] += copies
        if launches:
            self.stats["dispatches"] += launches
        return DispatchHandle(outputs=(out_v, out_m), dense=dense)

    def emit(self, handle: DispatchHandle) -> List[CanonicalRow]:
        rows: List[CanonicalRow] = []
        dense = handle.dense
        blocks = dense.chunk.blocks
        if not blocks.size:
            return rows
        # one readback per output kind, into memory this chunk owns
        ov_all, om_all = (t.cpu().numpy() for t in handle.outputs)
        n_rows = dense.chunk.groups[:, 2].tolist()
        key_start = dense.key_start.tolist()
        table = dense.table
        for (g, _, n_pad, off), bid in zip(blocks.tolist(), dense.block_ids.tolist()):
            b = n_rows[g]
            v = ov_all[off : off + b * n_pad].reshape(b, n_pad)
            m = om_all[off : off + b * n_pad].reshape(b, n_pad)
            keys = dense.keys[key_start[g] : key_start[g] + b]
            live = np.flatnonzero(m.any(axis=1))  # only non-empty outgoing messages
            # counted per row in the reference, so a counter appears only once hit
            for stat, count in (("mapped", live.size), ("empty", b - live.size)):
                if count:
                    self.stats[stat] += int(count)
            route, no = table.routes[bid], table.n_out[bid]
            for r, key in zip(live.tolist(), keys[live].tolist()):
                rows.append((route, v[r, :no], m[r, :no], key))
        return rows

    def info(self) -> Dict[str, Any]:
        d = self._base_info()
        if self.lease is not None:
            p = self.lease.plan
            table_bytes = p.src_bytes
            d.update(
                state=p.state,
                n_blocks=p.n_blocks,
                blocks_per_shard=p.n_blocks,
                table_bytes=table_bytes,
                table_bytes_per_shard=table_bytes,
                bytes_resident=self.lease.bytes_resident,
            )
        return d
