"""Tensorised, device-resident form of the compacted mapping (Algorithm 6).

The PyTorch counterpart of ``repro.core.dmm_jax``, limited to what the
consume paths run: the per-block lowering (:func:`compile_block`,
:func:`compile_dpm`), its device placement for the per-block engine
(:func:`place_blocks`), the two per-block apply functions
(:func:`apply_compacted`, the DMM gather, and :func:`apply_onehot`, the
paper's matrix-operator baseline), the fused block table
(:func:`compile_fused`) and its partition over a mesh's shards
(:func:`compile_fused_sharded`), and the incremental lowering the plan
manager runs across a schema change: :func:`recompile_columns` re-lowers
only the touched columns and :func:`splice_fused` splices them into the
previous plan's table.

The paper's final mapping function is a *set lookup*: for each dense set
element ``(q, p)`` with value 1, move payload slot ``p`` to output slot
``q``.  A compacted block becomes an index vector

    src    : (n_out_pad,)   int32; src[q] = p  or  -1 ("null" / filtered)

and the fused plan (:class:`FusedDMM`) stacks every block of a state into

    src2d      (n_blocks_pad, W) int32   all block index vectors, stacked in
               column order and right-padded with -1 to W = max(n_out_pad)
    routes     block t emits to business entity routes[t] = (r, w)
    n_out      true (unpadded) output width per block
    columns    (o, v) -> FusedColumn: the column super-set as global block
               ids plus the uid -> payload-slot lookup

``src2d`` and the uid tables' device copies live on the plan's ``device``
(a sharded plan's slices on their shards' devices); everything else is
host-side numpy, including ``table_host``, the numpy table the build
uploaded, which the splice copies from (so a rebuild never reads a table
back from the device).  A per-block plan placed with
:func:`place_blocks` keeps every block's ``src`` on the device too, as views
of one buffer uploaded once per state.  The ``LANE`` / ``SUBLANE`` padding of
the reference is kept as it is, so every table here equals the reference's
byte for byte; the CUDA kernels do not need it (they mask their own edges).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .dmm import DPM, BlockKey
from .registry import Registry

__all__ = [
    "LANE",
    "SUBLANE",
    "resolve_device",
    "pad_to_lane",
    "bucket_rows",
    "uid_lookup_table",
    "CompactedBlockMap",
    "compile_block",
    "compile_dpm",
    "apply_compacted",
    "onehot_matrix",
    "apply_onehot",
    "CompiledDMM",
    "place_blocks",
    "FusedColumn",
    "FusedDMM",
    "compile_fused",
    "global_uid_tables",
    "ShardedFusedDMM",
    "compile_fused_sharded",
    "recompile_columns",
    "splice_fused",
]

LANE = 128  # table row padding, kept from the reference for byte-equal tables
SUBLANE = 8  # block-count padding, likewise

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a :class:`torch.device`, a CUDA device with its index
    (so ``"cuda"`` and ``"cuda:0"`` compare equal); raises when a CUDA
    device is asked for and none exists (the port never falls back to the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def uid_lookup_table(uids) -> np.ndarray:
    """Dense uid -> position table: ``lut[uid] = k`` for the k-th uid in
    ``uids``, -1 elsewhere."""
    uids = np.asarray(list(uids), dtype=np.int64)
    if uids.size == 0:
        return np.empty(0, dtype=np.int32)
    lut = np.full(int(uids.max()) + 1, -1, dtype=np.int32)
    lut[uids] = np.arange(uids.size, dtype=np.int32)
    return lut


def pad_to_lane(n: int, lane: int = LANE) -> int:
    return max(lane, -(-n // lane) * lane)


def bucket_rows(n: int, floor: int = SUBLANE) -> int:
    """Round a batch/row count up to the next power of two (>= ``floor``).

    Per-chunk operands are padded to bucketed shapes, exactly as in the
    reference, so the port's packed buffers and outputs keep its shapes."""
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CompactedBlockMap:
    """One compacted mapping block: its host index vector and, once the
    plan is placed (:func:`place_blocks`), a device-resident copy."""

    key: BlockKey
    n_in: int  # true width of the incoming message (attrs of iD_v^o)
    n_out: int  # true width of the outgoing message (attrs of iR_w^r)
    src: np.ndarray  # int32 (n_out_pad,): input slot per output slot, -1 = null
    src_dev: Optional[torch.Tensor] = None  # int32 (n_out_pad,) on the plan's device

    @property
    def n_out_pad(self) -> int:
        return int(self.src.shape[0])

    def src_on(self, device: torch.device) -> torch.Tensor:
        """``src`` as a tensor on ``device``: the resident copy where the
        plan was placed there, else a copy of the host vector."""
        if self.src_dev is not None and self.src_dev.device == device:
            return self.src_dev
        return torch.from_numpy(self.src).to(device)


def compile_block(
    key: BlockKey, elements: Sequence, registry: Registry, lane: int = LANE
) -> CompactedBlockMap:
    """Lower one dense set ``{(q_uid, p_uid)}`` to an index vector."""
    o, v, r, w = key
    in_uids = registry.domain.get(o, v).uids
    out_uids = registry.range.get(r, w).uids
    in_pos = {u: k for k, u in enumerate(in_uids)}
    out_pos = {u: k for k, u in enumerate(out_uids)}
    src = np.full((pad_to_lane(len(out_uids), lane),), -1, dtype=np.int32)
    for q_uid, p_uid in elements:
        src[out_pos[q_uid]] = in_pos[p_uid]
    return CompactedBlockMap(key=key, n_in=len(in_uids), n_out=len(out_uids), src=src)


def apply_compacted(
    block: CompactedBlockMap,
    values: torch.Tensor,
    mask: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DMM mapping: batched masked gather.

    values: (..., n_in) payload, mask: (..., n_in) bool.
    Returns (out_values (..., n_out_pad), out_mask (..., n_out_pad) bool).
    """
    src = block.src_on(values.device).long()
    valid = src >= 0
    safe = torch.where(valid, src, 0)
    out_v = values.index_select(-1, safe)
    out_m = mask.to(torch.bool).index_select(-1, safe) & valid
    out_v = torch.where(out_m, out_v, fill)
    return out_v, out_m


def onehot_matrix(block: CompactedBlockMap, device: DeviceLike = "cpu") -> torch.Tensor:
    """The block as an explicit (n_out_pad, n_in) 0/1 float32 matrix -- the
    baseline representation the paper compacts away."""
    dev = torch.device(device)
    src = block.src_on(dev)
    cols = torch.arange(block.n_in, dtype=torch.int32, device=dev)
    return (src[:, None] == cols[None, :]).to(torch.float32)


def apply_onehot(
    block: CompactedBlockMap,
    values: torch.Tensor,
    mask: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline: ``out = M @ in`` against the block's 0/1 matrix.

    Mathematically identical to :func:`apply_compacted`; structurally it is
    the paper's Algorithm-1 world where the matrix itself is the operator.
    The contraction is a float32 multiply and sum, so no TF32 setting of
    the matrix units can touch it.  Returns (out_values (..., n_out_pad) in
    ``values.dtype``, out_mask (..., n_out_pad) bool).
    """
    m = onehot_matrix(block, values.device)  # (n_out_pad, n_in)
    out_v = (values.to(torch.float32).unsqueeze(-2) * m).sum(-1)
    out_m = (mask.to(torch.float32).unsqueeze(-2) * m).sum(-1) > 0.5
    out_v = torch.where(out_m, out_v, fill)
    return out_v.to(values.dtype), out_m


@dataclasses.dataclass
class CompiledDMM:
    """All compacted blocks of a state-i DPM, grouped by incoming (o, v).

    After :func:`place_blocks`, ``src_flat`` is the one device buffer that
    every block's ``src_dev`` views."""

    state: int
    by_column: Dict[Tuple[int, int], List[CompactedBlockMap]]
    src_flat: Optional[torch.Tensor] = None

    def column(self, o: int, v: int) -> List[CompactedBlockMap]:
        return self.by_column.get((o, v), [])

    @property
    def n_blocks(self) -> int:
        return sum(len(b) for b in self.by_column.values())

    @property
    def src_bytes(self) -> int:
        """Bytes of all block index vectors (what a placed plan holds on
        its device)."""
        return int(sum(b.src.nbytes for col in self.by_column.values() for b in col))

    def map_batch(
        self, o: int, v: int, values: torch.Tensor, mask: torch.Tensor
    ) -> List[Tuple[BlockKey, torch.Tensor, torch.Tensor]]:
        """Map a batch of dense messages of one (o, v) through every block in
        its column super-set (each block an independent mapping path, paper
        SS5.5)."""
        return [
            (block.key, *apply_compacted(block, values, mask))
            for block in self.column(o, v)
        ]


def compile_dpm(dpm: DPM, registry: Registry, lane: int = LANE) -> CompiledDMM:
    """Lower a whole iDPM super-set to index vectors, in sorted key order."""
    by_column: Dict[Tuple[int, int], List[CompactedBlockMap]] = {}
    for key, elements in sorted(dpm.items()):
        o, v, r, w = key
        by_column.setdefault((o, v), []).append(
            compile_block(key, elements, registry, lane)
        )
    return CompiledDMM(state=registry.state, by_column=by_column)


def place_blocks(compiled: CompiledDMM, device: DeviceLike = "cuda") -> CompiledDMM:
    """The per-block plan with every block's ``src`` resident on ``device``.

    All index vectors of the state go to the device in ONE host->device
    copy (their concatenation, ``src_flat``); each block's ``src_dev`` is a
    view of it.  Built once per state by the plan manager, so no dispatch
    copies an index vector."""
    dev = resolve_device(device)
    blocks = [b for col in compiled.by_column.values() for b in col]
    host = (np.concatenate([b.src for b in blocks]) if blocks
            else np.empty(0, dtype=np.int32))
    flat = torch.from_numpy(host).to(dev)
    by_column: Dict[Tuple[int, int], List[CompactedBlockMap]] = {}
    off = 0
    for ov, col in compiled.by_column.items():
        placed = []
        for b in col:
            placed.append(dataclasses.replace(b, src_dev=flat[off : off + b.n_out_pad]))
            off += b.n_out_pad
        by_column[ov] = placed
    return CompiledDMM(state=compiled.state, by_column=by_column, src_flat=flat)


@dataclasses.dataclass(frozen=True)
class FusedColumn:
    """Host-side routing for one incoming (schema o, version v) column:
    its payload-slot lookup, its global block ids (rows of ``src2d``) and
    its ``col_id`` in the plan-global uid tables."""

    o: int
    v: int
    n_in: int
    uid_pos: Dict[int, int]
    block_ids: np.ndarray  # int32 (k,): rows of FusedDMM.src2d
    col_id: int = -1  # position of this column in the plan's column order
    uids_arr: Optional[np.ndarray] = None  # int64 (n_in,): the column's uids, in slot order


@dataclasses.dataclass
class FusedDMM:
    """Every compacted block of a state-``i`` DPM, flattened for one-launch
    execution (see the module docstring for the table layout)."""

    state: int
    n_in_pad: int  # uniform dense-payload width (lane multiple)
    width: int  # W: uniform output width = max n_out_pad (lane multiple)
    n_blocks: int  # true block count (src2d rows beyond this are -1 pad)
    src2d: torch.Tensor  # int32 (n_blocks_pad, W), on the plan's device
    routes: List[Tuple[int, int]]  # block t -> business entity (r, w)
    n_out: np.ndarray  # int32 (n_blocks,): true output width per block
    columns: Dict[Tuple[int, int], FusedColumn]
    uid_slot: np.ndarray  # int32 (max_uid+1,): uid -> payload slot, -1 = none
    uid_col: np.ndarray  # int32 (max_uid+1,): uid -> owning col_id, -1 = none
    # column col_id owns the contiguous global block range
    # [col_block_start[c], col_block_start[c] + col_block_count[c])
    col_block_start: np.ndarray = None  # int32 (n_cols,)
    col_block_count: np.ndarray = None  # int32 (n_cols,)
    # device copies of the uid tables, for the device-densify path
    uid_slot_dev: Optional[torch.Tensor] = None
    uid_col_dev: Optional[torch.Tensor] = None
    table_host: Optional[np.ndarray] = None  # int32 (n_blocks_pad, W): src2d's host copy

    def column(self, o: int, v: int) -> Optional[FusedColumn]:
        return self.columns.get((o, v))


def _uid_tables_from(cols) -> Tuple[np.ndarray, np.ndarray]:
    """Dense global (uid -> payload slot, uid -> owning col_id) tables from
    ``(uid_pos dict, col_id)`` pairs; -1 marks uids no column knows."""
    cols = list(cols)
    max_uid = max((int(u) for pos, _ in cols for u in pos), default=-1)
    uid_slot = np.full(max_uid + 1, -1, dtype=np.int32)
    uid_col = np.full(max_uid + 1, -1, dtype=np.int32)
    for pos, cid in cols:
        for u, k in pos.items():
            uid_slot[u] = k
            uid_col[u] = cid
    return uid_slot, uid_col


def global_uid_tables(
    compiled: CompiledDMM, registry: Registry
) -> Tuple[np.ndarray, np.ndarray]:
    """The fused plan's global uid tables, derived from a per-block plan
    (column ids follow ``compiled.by_column`` insertion order, as
    :func:`compile_fused` assigns them)."""
    return _uid_tables_from(
        ({u: k for k, u in enumerate(registry.domain.get(o, v).uids)}, cid)
        for cid, (o, v) in enumerate(compiled.by_column)
    )


def _fused_tables(compiled: CompiledDMM, registry: Registry, lane: int = LANE) -> Tuple:
    """The host side of the fused block table, shared by the replicated and
    the sharded plan: ``(table, routes, n_out, columns, n_in_pad, width,
    n_blocks, uid_slot, uid_col, col_block_start, col_block_count)``."""
    routes: List[Tuple[int, int]] = []
    n_out: List[int] = []
    src_rows: List[np.ndarray] = []
    columns: Dict[Tuple[int, int], FusedColumn] = {}
    width = lane
    n_in_max = 1
    for blocks in compiled.by_column.values():
        for blk in blocks:
            width = max(width, blk.n_out_pad)
    for (o, v), blocks in compiled.by_column.items():
        sv = registry.domain.get(o, v)
        uid_pos = {u: k for k, u in enumerate(sv.uids)}
        n_in_max = max(n_in_max, len(sv.uids))
        ids = []
        for blk in blocks:
            ids.append(len(routes))
            routes.append((blk.key[2], blk.key[3]))
            n_out.append(blk.n_out)
            row = np.full((width,), -1, dtype=np.int32)
            row[: blk.n_out_pad] = blk.src
            src_rows.append(row)
        columns[(o, v)] = FusedColumn(
            o=o,
            v=v,
            n_in=len(sv.uids),
            uid_pos=uid_pos,
            block_ids=np.asarray(ids, dtype=np.int32),
            col_id=len(columns),
            uids_arr=np.asarray(sv.uids, dtype=np.int64),
        )
    # plan-global uid tables: uids are globally unique (one registry
    # counter), so one dense table resolves any payload uid to its slot and
    # its owning column; the owner check keeps the per-column semantics
    uid_slot, uid_col = _uid_tables_from(
        (col.uid_pos, col.col_id) for col in columns.values()
    )
    n_blocks = len(routes)
    n_blocks_pad = max(SUBLANE, -(-max(n_blocks, 1) // SUBLANE) * SUBLANE)
    table = np.full((n_blocks_pad, width), -1, dtype=np.int32)
    if src_rows:
        table[:n_blocks] = np.stack(src_rows)
    # block ids are assigned sequentially per column, so each column's
    # blocks are the contiguous range [start, start + count)
    col_block_start = np.asarray(
        [int(c.block_ids[0]) if c.block_ids.size else 0 for c in columns.values()],
        dtype=np.int32,
    )
    col_block_count = np.asarray(
        [c.block_ids.size for c in columns.values()], dtype=np.int32
    )
    return (table, routes, np.asarray(n_out, dtype=np.int32), columns,
            pad_to_lane(n_in_max, lane), width, n_blocks, uid_slot, uid_col,
            col_block_start, col_block_count)


def _assemble_replicated(parts: Tuple, state: int, device: DeviceLike) -> FusedDMM:
    """Place a host table bundle (:func:`_fused_tables` layout) on
    ``device`` as a replicated :class:`FusedDMM`; the bundle's numpy table
    stays on the plan as ``table_host``."""
    dev = resolve_device(device)
    (table, routes, n_out, columns, n_in_pad, width, n_blocks, uid_slot,
     uid_col, cb_start, cb_count) = parts
    return FusedDMM(  # metl: allow[plan-publish-single-site] the port's lowering primitive, the counterpart of repro.core.dmm_jax; only repro_torch.etl.plan.PlanManager reaches it, through compile_fused and splice_fused
        state=state,
        n_in_pad=n_in_pad,
        width=width,
        n_blocks=n_blocks,
        src2d=torch.from_numpy(table).to(dev),
        routes=routes,
        n_out=n_out,
        columns=columns,
        uid_slot=uid_slot,
        uid_col=uid_col,
        col_block_start=cb_start,
        col_block_count=cb_count,
        uid_slot_dev=torch.from_numpy(uid_slot).to(dev),
        uid_col_dev=torch.from_numpy(uid_col).to(dev),
        table_host=table,
    )


def compile_fused(
    compiled: CompiledDMM,
    registry: Registry,
    lane: int = LANE,
    *,
    device: DeviceLike = "cuda",
) -> FusedDMM:
    """Flatten a :class:`CompiledDMM` into the fused block table and place
    its device-side tables (``src2d``, ``uid_slot_dev``, ``uid_col_dev``) on
    ``device``.  Built by the plan manager; this full rebuild is the
    bit-exactness oracle of the incremental path (:func:`splice_fused`)."""
    return _assemble_replicated(_fused_tables(compiled, registry, lane), compiled.state,
                                device)


@dataclasses.dataclass
class ShardedFusedDMM:
    """The fused block table partitioned over the mesh's shards.

    Global block ``t`` (row ``t`` of the replicated table, in column order)
    lives on shard ``t // blocks_per_shard`` at local row ``t %
    blocks_per_shard``; the contiguous partition keeps emission order
    identical to the replicated engine.  Pad rows of every shard are -1,
    so stray routing never makes output.  ``src3d`` holds one int32 stack
    of shape ``(hi - lo, n_blocks_pad_loc, W)`` per entry ``(device, lo,
    hi)`` of ``groups``: the shards that share a device are one tensor
    there (on one card, the whole table).  ``uid_slot_dev`` / ``uid_col_dev``
    are the uid tables on each of those devices.  ``routes`` / ``n_out`` /
    ``columns`` are host metadata in global order (per shard:
    :meth:`shard_routes` / :meth:`shard_n_out`).
    """

    state: int
    n_shards: int
    blocks_per_shard: int
    n_in_pad: int
    width: int
    n_blocks: int  # true global block count
    src3d: Tuple[torch.Tensor, ...]  # per device group: (n_loc, n_blocks_pad_loc, W) int32
    groups: Tuple[Tuple[torch.device, int, int], ...]  # (device, lo, hi) per stack
    routes: List[Tuple[int, int]]  # global block t -> business entity (r, w)
    n_out: np.ndarray  # int32 (n_blocks,) true output width per block
    columns: Dict[Tuple[int, int], FusedColumn]
    uid_slot: np.ndarray  # int32 (max_uid+1,): uid -> payload slot, -1 = none
    uid_col: np.ndarray  # int32 (max_uid+1,): uid -> owning col_id, -1 = none
    col_block_start: np.ndarray = None  # int32 (n_cols,): see FusedDMM
    col_block_count: np.ndarray = None  # int32 (n_cols,)
    uid_slot_dev: Tuple[torch.Tensor, ...] = ()  # one copy per device group
    uid_col_dev: Tuple[torch.Tensor, ...] = ()
    # int32 (n_blocks_pad, W): the table in global block order, on the host
    table_host: Optional[np.ndarray] = None

    def column(self, o: int, v: int) -> Optional[FusedColumn]:
        return self.columns.get((o, v))

    @property
    def n_blocks_pad_loc(self) -> int:
        return int(self.src3d[0].shape[1])

    @property
    def table_bytes(self) -> int:
        """Device-resident block-table bytes over all shards."""
        return int(sum(t.nbytes for t in self.src3d))

    @property
    def table_bytes_per_shard(self) -> int:
        """Device-resident block-table bytes held by ONE shard."""
        return self.n_blocks_pad_loc * self.width * 4

    def shard_slice(self, s: int) -> Tuple[int, int]:
        """Global block id range [lo, hi) owned by shard ``s``."""
        lo = s * self.blocks_per_shard
        return lo, min(lo + self.blocks_per_shard, self.n_blocks)

    def shard_routes(self, s: int) -> List[Tuple[int, int]]:
        lo, hi = self.shard_slice(s)
        return self.routes[lo:hi]

    def shard_n_out(self, s: int) -> np.ndarray:
        lo, hi = self.shard_slice(s)
        return self.n_out[lo:hi]


def compile_fused_sharded(
    compiled: CompiledDMM,
    registry: Registry,
    *,
    mesh: Optional[Any] = None,
    n_shards: Optional[int] = None,
    lane: int = LANE,
    device: DeviceLike = "cuda",
) -> ShardedFusedDMM:
    """Partition the fused block table over ``n_shards`` (the mesh's
    ``data`` size when a mesh is given) and place each shard's slice on its
    device of ``mesh`` (:class:`repro_torch.launch.mesh.ETLMesh`).  Without a
    mesh every shard goes to ``device``."""
    if mesh is not None:
        if n_shards is not None and n_shards != mesh.shape["data"]:
            raise ValueError(f"n_shards={n_shards} != the mesh's {mesh.shape['data']} shards")
        n_shards = mesh.shape["data"]
    elif n_shards is None:
        raise ValueError("need a mesh or an explicit n_shards")
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} < 1")
    groups = mesh.groups if mesh is not None else ((resolve_device(device), 0, n_shards),)
    return _assemble_sharded(
        _fused_tables(compiled, registry, lane), compiled.state, groups=groups,
        n_shards=n_shards,
    )


def _assemble_sharded(
    parts: Tuple,
    state: int,
    *,
    groups: Tuple[Tuple[torch.device, int, int], ...],
    n_shards: int,
) -> ShardedFusedDMM:
    """Partition a host table bundle (:func:`_fused_tables`) over
    ``n_shards`` contiguous block ranges, as the reference does, and place
    one stack per device group ``(device, lo, hi)``; the bundle's numpy
    table stays on the plan as ``table_host``."""
    (table, routes, n_out, columns, n_in_pad, width, n_blocks, uid_slot,
     uid_col, cb_start, cb_count) = parts
    per = -(-max(n_blocks, 1) // n_shards)
    per_pad = max(SUBLANE, -(-per // SUBLANE) * SUBLANE)
    src3d_np = np.full((n_shards, per_pad, width), -1, dtype=np.int32)
    for s in range(n_shards):
        lo, hi = s * per, min((s + 1) * per, n_blocks)
        if hi > lo:
            src3d_np[s, : hi - lo] = table[lo:hi]
    host = torch.from_numpy(src3d_np)
    return ShardedFusedDMM(  # metl: allow[plan-publish-single-site] the port's lowering primitive, the counterpart of repro.core.dmm_jax; only repro_torch.etl.plan.PlanManager calls compile_fused_sharded
        state=state,
        n_shards=n_shards,
        blocks_per_shard=per,
        n_in_pad=n_in_pad,
        width=width,
        n_blocks=n_blocks,
        src3d=tuple(host[lo:hi].to(dev) for dev, lo, hi in groups),
        groups=groups,
        routes=routes,
        n_out=n_out,
        columns=columns,
        uid_slot=uid_slot,
        uid_col=uid_col,
        col_block_start=cb_start,
        col_block_count=cb_count,
        uid_slot_dev=tuple(torch.from_numpy(uid_slot).to(dev) for dev, _, _ in groups),
        uid_col_dev=tuple(torch.from_numpy(uid_col).to(dev) for dev, _, _ in groups),
        table_host=table,
    )


# ---------------------------------------------------------------------------
# Incremental recompaction: rebuild only the touched columns (PlanManager)
# ---------------------------------------------------------------------------


def recompile_columns(
    compiled: CompiledDMM, dpm: DPM, registry: Registry, touched, *, lane: int = LANE
) -> CompiledDMM:
    """Re-lower a DPM after a localised change, reusing every block of an
    untouched column by block key.

    ``touched`` is the set of incoming ``(o, v)`` columns whose mapping paths
    changed since ``compiled`` was built (the plan manager's DPM diff).
    Reuse is safe because a registry version is immutable once cut; the
    caller must list every column whose elements changed, or a stale block
    is reused.  Equal, block for block, to :func:`compile_dpm` of ``dpm``.
    """
    touched = frozenset(touched)
    old_by_key = {blk.key: blk for blocks in compiled.by_column.values() for blk in blocks}
    by_column: Dict[Tuple[int, int], List[CompactedBlockMap]] = {}
    for key, elements in sorted(dpm.items()):
        o, v, r, w = key
        blk = old_by_key.get(key) if (o, v) not in touched else None
        if blk is None:
            blk = compile_block(key, elements, registry, lane)
        by_column.setdefault((o, v), []).append(blk)
    return CompiledDMM(state=registry.state, by_column=by_column)


def _vectorised_uid_tables(columns) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`_uid_tables_from` by two scatters over the columns'
    ``uids_arr``; equal to it because registry uids are globally unique, so
    no uid belongs to two columns and the scatter order cannot matter."""
    cols = [c for c in columns if c.uids_arr is not None and c.uids_arr.size]
    if not cols:
        return np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32)
    all_uids = np.concatenate([c.uids_arr for c in cols])
    sizes = np.asarray([c.uids_arr.size for c in cols], dtype=np.int64)
    col_ids = np.asarray([c.col_id for c in cols], dtype=np.int32)
    uid_slot = np.full(int(all_uids.max()) + 1, -1, dtype=np.int32)
    uid_col = np.full(uid_slot.size, -1, dtype=np.int32)
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    uid_slot[all_uids] = (np.arange(all_uids.size, dtype=np.int64) - starts).astype(np.int32)
    uid_col[all_uids] = np.repeat(col_ids, sizes)
    return uid_slot, uid_col


def _spliced_tables(
    old: Union[FusedDMM, ShardedFusedDMM], compiled: CompiledDMM, registry: Registry,
    touched, lane: int,
) -> Tuple:
    """A :func:`_fused_tables` bundle for ``compiled`` made by splicing:
    untouched columns reuse the old plan's table rows (one fancy-index copy
    from its host table) and :class:`FusedColumn` metadata; only touched or
    new columns fill their rows block by block and build their uid dict."""
    width = lane
    for blocks in compiled.by_column.values():
        for blk in blocks:
            width = max(width, blk.n_out_pad)
    routes: List[Tuple[int, int]] = []
    n_out: List[int] = []
    columns: Dict[Tuple[int, int], FusedColumn] = {}
    n_in_max = 1
    reuse_new: List[int] = []  # new global row of each reused column's first block
    reuse_old: List[np.ndarray] = []  # that column's old block ids
    fresh: List[Tuple[int, np.ndarray]] = []  # (row, src) of each rebuilt block
    for (o, v), blocks in compiled.by_column.items():
        old_col = None if (o, v) in touched else old.columns.get((o, v))
        if old_col is not None and old_col.block_ids.size != len(blocks):
            old_col = None  # the column's block layout changed: rebuild it
        start = len(routes)
        for blk in blocks:
            routes.append((blk.key[2], blk.key[3]))
            n_out.append(blk.n_out)
            if old_col is None:
                fresh.append((len(routes) - 1, blk.src))
        if old_col is not None:
            uid_pos, n_in, uids_arr = old_col.uid_pos, old_col.n_in, old_col.uids_arr
            reuse_new.append(start)
            reuse_old.append(old_col.block_ids)
        else:
            sv = registry.domain.get(o, v)
            uid_pos = {u: k for k, u in enumerate(sv.uids)}
            uids_arr = np.asarray(sv.uids, dtype=np.int64)
            n_in = len(sv.uids)
        n_in_max = max(n_in_max, n_in)
        columns[(o, v)] = FusedColumn(
            o=o,
            v=v,
            n_in=n_in,
            uid_pos=uid_pos,
            block_ids=np.arange(start, len(routes), dtype=np.int32),
            col_id=len(columns),
            uids_arr=uids_arr,
        )
    n_blocks = len(routes)
    n_blocks_pad = max(SUBLANE, -(-max(n_blocks, 1) // SUBLANE) * SUBLANE)
    table = np.full((n_blocks_pad, width), -1, dtype=np.int32)
    if reuse_new:
        new_ids = np.concatenate([np.arange(s, s + ids.size, dtype=np.int64)
                                  for s, ids in zip(reuse_new, reuse_old)])
        old_ids = np.concatenate([ids.astype(np.int64) for ids in reuse_old])
        # the width shrinks when the widest column is rebuilt narrower: the
        # cut tail of every reused row is -1 pad (width still covers each
        # reused block's n_out_pad)
        old_np = old.table_host
        w = min(old_np.shape[1], width)
        table[new_ids, :w] = old_np[old_ids, :w]
    for t, src in fresh:
        table[t, : src.shape[0]] = src
    uid_slot, uid_col = _vectorised_uid_tables(columns.values())
    col_block_start = np.asarray(
        [int(c.block_ids[0]) if c.block_ids.size else 0 for c in columns.values()],
        dtype=np.int32,
    )
    col_block_count = np.asarray([c.block_ids.size for c in columns.values()], dtype=np.int32)
    return (table, routes, np.asarray(n_out, dtype=np.int32), columns,
            pad_to_lane(n_in_max, lane), width, n_blocks, uid_slot, uid_col,
            col_block_start, col_block_count)


def splice_fused(
    plan: Union[FusedDMM, ShardedFusedDMM],
    compiled: CompiledDMM,
    registry: Registry,
    touched,
    *,
    lane: int = LANE,
) -> Union[FusedDMM, ShardedFusedDMM]:
    """Rebuild a fused plan incrementally: splice ``compiled``'s touched
    columns into ``plan``'s table instead of re-flattening every column.

    ``plan`` is the previous epoch's :class:`FusedDMM` (the result goes to
    the same device) or :class:`ShardedFusedDMM` (the same shard count and
    device groups; the new table is partitioned afresh, so a change of
    width or block count moves the shard boundaries as a full build
    would).  ``touched`` is the changed-column set (see
    :func:`recompile_columns`).  Columns absent from ``compiled`` (deleted
    versions, or columns a residency policy keeps out) drop out of the
    table; columns absent from ``plan`` are built from scratch.  The old
    table is read from its host copy (``table_host``), never from the
    device, and its device storage is left as it is: chunks in flight may
    still read it.  Equal to :func:`compile_fused` /
    :func:`compile_fused_sharded` of the same ``compiled``, byte for byte.
    """
    parts = _spliced_tables(plan, compiled, registry, frozenset(touched), lane)
    if isinstance(plan, ShardedFusedDMM):
        return _assemble_sharded(parts, compiled.state, groups=plan.groups,
                                 n_shards=plan.n_shards)
    return _assemble_replicated(parts, compiled.state, plan.src2d.device)
