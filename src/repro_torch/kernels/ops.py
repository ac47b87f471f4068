"""Public entry points of the kernels, as the engines and models call them.

Counterpart of ``repro.kernels.ops``: the mapping ops of the consume paths,
and :func:`attention` and :func:`moe_combine` of the model stack.  Each op
picks kernel or plain version by the device of its tensors (a CUDA tensor
launches the Hopper kernel or raises, a CPU tensor takes the plain PyTorch
version); :func:`dmm_apply`'s ``impl`` picks the per-block *algorithm*, the
compacted gather or the one-hot contraction.

Dispatch handles, not results: every op returns its output tensors without
synchronising -- no ``.item()``, ``.cpu()``, ``.tolist()`` or
``torch.cuda.synchronize()`` here.  The engines' ``emit`` stage is the only
sync point.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import build
from .blocks import BlockChunk
from .densify_map import densify_map, densify_map_chunk, densify_map_shard, split_outputs
from .flash_attention import flash_attention
from .masked_gather import masked_gather, masked_gather_blocks
from .moe_combine import moe_combine as _moe_combine_kernel
from .onehot_map import onehot_map, onehot_map_blocks
from .ref import route_offset
from .segmented_gather import (arena_layout, arena_views, segmented_gather,
                               segmented_gather_chunk, segmented_gather_shard)

__all__ = ["IMPLS", "dmm_apply", "dmm_apply_blocks", "dmm_apply_fused",
           "dmm_apply_columnar", "dmm_apply_sharded", "dmm_apply_columnar_sharded",
           "ChunkOutput", "dmm_apply_dense", "dmm_apply_packed", "dispatch_count",
           "attention", "moe_combine"]

# Device-dispatch accounting: one per dmm_apply* call, and one per block that
# dmm_apply_blocks maps (the model ops are no mapping dispatches and do not
# count).  The fused-engine contract (one dispatch per consume chunk, not
# one per block) is asserted against it.
dispatch_count = 0

_PER_BLOCK = {"gather": masked_gather, "onehot": onehot_map}
_PER_CHUNK = {"gather": masked_gather_blocks, "onehot": onehot_map_blocks}
IMPLS = tuple(_PER_BLOCK)  # the per-block algorithms dmm_apply takes


def dmm_apply(
    values: torch.Tensor,
    mask: torch.Tensor,
    src: torch.Tensor,
    *,
    impl: str = "gather",
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one compacted block (index vector ``src``) to a payload batch.

    impl:
      "gather"   the compacted masked gather (the DMM path,
                 :func:`~repro_torch.kernels.masked_gather.masked_gather`)
      "onehot"   the one-hot contraction (the paper's baseline,
                 :func:`~repro_torch.kernels.onehot_map.onehot_map`)

    Any other ``impl`` raises.
    """
    global dispatch_count
    fn = _PER_BLOCK.get(impl)
    if fn is None:
        raise ValueError(f"unknown impl {impl!r} (per-block: {sorted(_PER_BLOCK)})")
    dispatch_count += 1
    return fn(values, mask, src, fill=fill)


def dmm_apply_blocks(
    chunk: BlockChunk,
    src_flat: torch.Tensor,
    *,
    impl: str = "gather",
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Apply every compacted block of a per-block chunk in one call: per
    group two copies of its payload, per block one :func:`dmm_apply` worth
    of work (:mod:`repro_torch.kernels.blocks` has the layout).

    On a CUDA device the kernel library's launcher issues them all; on the
    CPU the plain version walks the same descriptors.  Returns ``(out_v,
    out_m, copies, launches)``, the output arenas not synchronised, and adds
    one dispatch per block mapped to ``dispatch_count``."""
    global dispatch_count
    fn = _PER_CHUNK.get(impl)
    if fn is None:
        raise ValueError(f"unknown impl {impl!r} (per-block: {sorted(_PER_CHUNK)})")
    out = fn(chunk, src_flat, fill=fill)
    dispatch_count += out[3]
    return out


def dmm_apply_fused(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src2d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ALL compacted blocks a host-densified chunk touches in one
    dispatch (:func:`~repro_torch.kernels.segmented_gather.segmented_gather`).

    ``src2d`` is the state's stacked block table (built once per state by
    :func:`repro_torch.core.dmm_torch.compile_fused`); ``rows``/``blks``
    route output row ``s`` to (event row ``rows[s]``, block ``blks[s]``).
    """
    global dispatch_count
    dispatch_count += 1
    return segmented_gather(values, mask, rows, blks, src2d, fill=fill)


# The sharded ops run on an ETLMesh (repro_torch.launch.mesh): shard s on
# mesh.devices[s].  The block table arrives as one stack per device group
# (ShardedFusedDMM.src3d), or as one tensor when every shard is on one
# device.  Each group's shards are mapped by ONE launch on its device, on
# the chunk's operands copied there (a no-op on the operands' own device);
# the groups' outputs are gathered onto the operands' device with
# asynchronous peer copies, so the op returns one stacked (n_shards, S_loc,
# W) pair and never synchronises.


def _stacks(src3d: Union[torch.Tensor, Sequence[torch.Tensor]], mesh: Any):
    """``(device, lo, hi, table stack)`` per device group of ``mesh``."""
    parts = (src3d,) if isinstance(src3d, torch.Tensor) else tuple(src3d)
    groups = mesh.groups
    if len(parts) != len(groups):
        raise ValueError(f"{len(parts)} table stacks for the mesh's {len(groups)} devices")
    for (dev, lo, hi), t in zip(groups, parts):
        if t.device != dev or t.shape[0] != hi - lo:
            raise ValueError(f"table stack {tuple(t.shape)} on {t.device}, the mesh "
                             f"puts shards [{lo}, {hi}) on {dev}")
    return [(dev, lo, hi, t) for (dev, lo, hi), t in zip(groups, parts)]


def _per_device(table, stacks) -> Tuple[torch.Tensor, ...]:
    """A table needed on every device group: one tensor (one group) or one
    per group, each on its group's device."""
    parts = (table,) if isinstance(table, torch.Tensor) else tuple(table)
    if len(parts) != len(stacks) or any(p.device != st[0] for p, st in zip(parts, stacks)):
        raise ValueError("the uid tables must lie one on each device of the mesh")
    return parts


def _gather(outs, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device groups' (values, mask) stacks as one pair on ``device``."""
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i].to(device, non_blocking=True) for o in outs])
                 for i in range(2))


def _sharded(values, mask, rows, blks, src3d, *, mesh, fill):
    """:func:`dmm_apply_sharded`'s work, not counted."""
    home = values.device
    outs = [
        segmented_gather_shard(
            values.to(dev, non_blocking=True), mask.to(dev, non_blocking=True),
            rows[lo:hi].to(dev, non_blocking=True), blks[lo:hi].to(dev, non_blocking=True),
            t, fill=fill,
        )
        for dev, lo, hi, t in _stacks(src3d, mesh)
    ]
    return _gather(outs, home)


def dmm_apply_sharded(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src3d: Union[torch.Tensor, Sequence[torch.Tensor]],
    *,
    mesh: Any,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded fused mapping of a host-densified chunk: each shard maps its
    own routing through its own slice of the block table, over the shared
    payload (:func:`~repro_torch.kernels.segmented_gather.
    segmented_gather_shard`, one launch per device).

    ``rows``/``blks`` are (n_shards, S_loc) int32 with shard-local block ids
    (:meth:`repro_torch.etl.engines.ShardedEngine._shard_split`).  Returns
    the stacked ((n_shards, S_loc, W) values, int8 mask) on ``values``'s
    device; rows past a shard's true routing length are padding the caller
    drops.  One dispatch per call, however many shards.
    """
    global dispatch_count
    dispatch_count += 1
    return _sharded(values, mask, rows, blks, src3d, mesh=mesh, fill=fill)


# The packed layout of one device-densify chunk (built by
# repro_torch.etl.engines._pack_columnar):
#
#     [ uids(NI) | val_bits(NI) | starts(B) | counts(B) | ev_col(B)
#       | rows | blks ]
#
# where rows/blks are (S,) for the replicated table, or the (n_shards, S_loc)
# pair flattened (all shards' rows, then all shards' blks) for the sharded
# one.  Values travel as int32 bit patterns, so the chunk is one int32 buffer
# and one host->device transfer.


def dmm_apply_columnar(
    packed: torch.Tensor,
    uid_slot: torch.Tensor,
    uid_col: torch.Tensor,
    src2d: torch.Tensor,
    *,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve, densify and map a whole packed chunk in ONE dispatch
    (:func:`~repro_torch.kernels.densify_map.densify_map`).

    ``uid_slot``/``uid_col``/``src2d`` are the plan's device tables,
    uploaded once per state.  Returns ((n_rows, W) values, (n_rows, W) int8
    mask); rows past the true routing length are padding the caller slices
    off.
    """
    global dispatch_count
    dispatch_count += 1
    return densify_map(
        packed, uid_slot, uid_col, src2d, n_items=n_items, n_events=n_events,
        n_rows=n_rows, k=k, fill=fill,
    )


def _columnar_sharded(packed, uid_slot, uid_col, src3d, *, mesh, n_items, n_events,
                      n_rows, k, n_shards, fill):
    """:func:`dmm_apply_columnar_sharded`'s work, not counted."""
    if n_shards != mesh.shape["data"]:
        raise ValueError(f"n_shards={n_shards} != the mesh's {mesh.shape['data']} shards")
    home = packed.device
    stacks = _stacks(src3d, mesh)
    slots, cols = _per_device(uid_slot, stacks), _per_device(uid_col, stacks)
    outs = [
        densify_map_shard(
            packed.to(dev, non_blocking=True), sl, cl, t, n_items=n_items,
            n_events=n_events, n_rows=n_rows, k=k, n_shards=n_shards, shard_lo=lo,
            fill=fill,
        )
        for (dev, lo, _, t), sl, cl in zip(stacks, slots, cols)
    ]
    return _gather(outs, home)


def dmm_apply_columnar_sharded(
    packed: torch.Tensor,
    uid_slot: Union[torch.Tensor, Sequence[torch.Tensor]],
    uid_col: Union[torch.Tensor, Sequence[torch.Tensor]],
    src3d: Union[torch.Tensor, Sequence[torch.Tensor]],
    *,
    mesh: Any,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    n_shards: int,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve, densify and map a packed chunk of the sharded path in ONE
    dispatch (:func:`~repro_torch.kernels.densify_map.densify_map_shard`,
    one launch per device; each shard resolves the replicated items itself).

    ``n_rows`` is S_loc, the routing length of one shard; ``uid_slot`` /
    ``uid_col`` are the plan's uid tables, one per device group like
    ``src3d`` (or one tensor when every shard is on one device).  Returns
    the stacked ((n_shards, S_loc, W) values, int8 mask) on ``packed``'s
    device.
    """
    global dispatch_count
    dispatch_count += 1
    return _columnar_sharded(packed, uid_slot, uid_col, src3d, mesh=mesh, n_items=n_items,
                             n_events=n_events, n_rows=n_rows, k=k, n_shards=n_shards,
                             fill=fill)


class ChunkOutput(NamedTuple):
    """What :func:`dmm_apply_packed` and :func:`dmm_apply_dense` return: the
    device allocation ``buf`` that starts with the chunk's ``shape`` =
    (n_shards, S, W) outputs, not synchronised (all float32 values, then all
    int8 masks; views ``values`` and ``mask``), and the host->device
    ``copies`` and the ``dispatches`` that produced them."""

    buf: torch.Tensor
    shape: Tuple[int, int, int]
    copies: int
    dispatches: int

    @property
    def values(self) -> torch.Tensor:
        return split_outputs(self.buf, *self.shape)[0]

    @property
    def mask(self) -> torch.Tensor:
        return split_outputs(self.buf, *self.shape)[1]


def dmm_apply_packed(
    host: torch.Tensor,
    uid_slot: Union[torch.Tensor, Sequence[torch.Tensor]],
    uid_col: Union[torch.Tensor, Sequence[torch.Tensor]],
    table: Union[torch.Tensor, Sequence[torch.Tensor]],
    *,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    mesh: Optional[Any] = None,
    n_shards: int = 1,
    fill: float = 0.0,
) -> ChunkOutput:
    """Resolve, densify and map a packed chunk that lies in a host arena in
    ONE dispatch: the engines' device-densify route.

    ``host`` is a uint8 arena holding the chunk in the packed layout above,
    pinned when the tables are on a CUDA device.  Without ``mesh``,
    ``table`` is the replicated (n_blocks, W) block table and the routing
    is (S,); with one, it is the sharded table (one stack per device group,
    :func:`dmm_apply_columnar_sharded`) and the routing (``n_shards``,
    S_loc).  When every shard lies on one device (the replicated table
    always does), one call
    (:func:`~repro_torch.kernels.densify_map.densify_map_chunk`) copies the
    chunk to that device and launches the kernel, and its reported copies
    and launches are returned (on the CPU the plain version runs on a copy
    of the arena).  A mesh over several cards takes the per-device route
    of :func:`dmm_apply_columnar_sharded`, fed by one copy from the arena:
    1 copy and 1 dispatch, one launch per card.  Adds the dispatches to
    ``dispatch_count``.  The caller keeps ``host`` unchanged until the copy
    has run (an event recorded after this call)."""
    global dispatch_count
    sizes = dict(n_items=n_items, n_events=n_events, n_rows=n_rows, k=k)
    if mesh is None:
        if n_shards != 1:
            raise ValueError(f"n_shards={n_shards} without a mesh")
        buf, copies, dispatches = densify_map_chunk(host, uid_slot, uid_col, table,
                                                    fill=fill, **sizes)
        dispatch_count += dispatches
        return ChunkOutput(buf, (1, n_rows, table.shape[-1]), copies, dispatches)
    if n_shards != mesh.shape["data"]:
        raise ValueError(f"n_shards={n_shards} != the mesh's {mesh.shape['data']} shards")
    stacks = _stacks(table, mesh)
    w = stacks[0][3].shape[2]
    if len(stacks) == 1:
        (_, lo, _, t), = stacks
        (sl,), (cl,) = _per_device(uid_slot, stacks), _per_device(uid_col, stacks)
        buf, copies, dispatches = densify_map_chunk(
            host, sl, cl, t, n_route=n_shards, shard_lo=lo, fill=fill, **sizes)
    else:
        n_bytes = 4 * (route_offset(n_items, n_events) + 2 * n_shards * n_rows)
        _check_host(host, n_bytes)
        packed = host[:n_bytes].view(torch.int32).to(stacks[0][0], non_blocking=True)
        buf = _one_allocation(*_columnar_sharded(packed, uid_slot, uid_col, table, mesh=mesh,
                                                 n_shards=n_shards, fill=fill, **sizes))
        copies, dispatches = 1, 1
    dispatch_count += dispatches
    return ChunkOutput(buf, (n_shards, n_rows, w), copies, dispatches)


def dmm_apply_dense(
    host: torch.Tensor,
    table: Union[torch.Tensor, Sequence[torch.Tensor]],
    *,
    n_events: int,
    n_in: int,
    n_rows: int,
    mesh: Optional[Any] = None,
    n_shards: int = 1,
    fill: float = 0.0,
) -> ChunkOutput:
    """Map a host-densified chunk that lies in a host arena in ONE
    dispatch: the engines' host-densify route.

    ``host`` is a uint8 arena holding the chunk's values (n_events, n_in)
    float32 and mask int8 and its routing, rows and blks (``n_shards``,
    n_rows) int32, at the offsets of
    :func:`~repro_torch.kernels.segmented_gather.arena_layout`, pinned when
    the table is on a CUDA device.  Without ``mesh``, ``table`` is the
    replicated (n_blocks, W) block table; with one, it is the sharded table
    (one stack per device group, :func:`dmm_apply_sharded`) and the blocks
    are shard-local.  When every shard lies on one device (the replicated
    table always does), one call
    (:func:`~repro_torch.kernels.segmented_gather.segmented_gather_chunk`)
    makes the four copies to that device and the launch, and its reported
    copies and launches are returned (on the CPU the plain version runs on
    a copy of the arena).  A mesh over several cards takes the per-device
    route of :func:`dmm_apply_sharded`, fed by four copies from the arena:
    4 copies and 1 dispatch, one launch per card.  Adds the dispatches to
    ``dispatch_count``.  The caller keeps ``host`` unchanged until the
    copies have run (an event recorded after this call)."""
    global dispatch_count
    sizes = dict(n_events=n_events, n_in=n_in, n_rows=n_rows)
    if mesh is None:
        if n_shards != 1:
            raise ValueError(f"n_shards={n_shards} without a mesh")
        buf, copies, dispatches = segmented_gather_chunk(host, table, fill=fill, **sizes)
        dispatch_count += dispatches
        return ChunkOutput(buf, (1, n_rows, table.shape[-1]), copies, dispatches)
    if n_shards != mesh.shape["data"]:
        raise ValueError(f"n_shards={n_shards} != the mesh's {mesh.shape['data']} shards")
    stacks = _stacks(table, mesh)
    w = stacks[0][3].shape[2]
    if len(stacks) == 1:
        buf, copies, dispatches = segmented_gather_chunk(host, stacks[0][3], n_route=n_shards,
                                                         fill=fill, **sizes)
    else:
        _check_host(host, arena_layout(n_events, n_in, n_shards, n_rows)[1])
        operands = [x.to(stacks[0][0], non_blocking=True)
                    for x in arena_views(host, n_events, n_in, n_shards, n_rows)]
        buf = _one_allocation(*_sharded(*operands, table, mesh=mesh, fill=fill))
        copies, dispatches = len(operands), 1
    dispatch_count += dispatches
    return ChunkOutput(buf, (n_shards, n_rows, w), copies, dispatches)


def _check_host(host: torch.Tensor, n_bytes: int) -> None:
    """What a mesh over several cards asks of the host arena it copies
    from: :func:`~repro_torch.kernels.build.check_arena`, and pinned."""
    build.check_arena(host, n_bytes)
    if not host.is_pinned():
        raise ValueError("a CUDA dispatch needs a pinned host arena")


def _one_allocation(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A (values, mask) pair copied into one uint8 allocation on their
    device, as :class:`ChunkOutput` holds it, without synchronising."""
    buf = torch.empty(5 * values.numel(), dtype=torch.uint8, device=values.device)
    for dst, src in zip(split_outputs(buf, *values.shape), (values, mask)):
        dst.copy_(src, non_blocking=True)
    return buf


def moe_combine(expert_out: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """Combine expert outputs: (E, C, D), (T, E, C) -> (T, D)
    (:func:`~repro_torch.kernels.moe_combine.moe_combine`, which takes its
    operands the other way round)."""
    return _moe_combine_kernel(combine, expert_out)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    n_rep: int = 1,
) -> torch.Tensor:
    """Single-kernel attention: q (N, S, hd), k/v (N/n_rep, T, hd)
    (:func:`~repro_torch.kernels.flash_attention.flash_attention`)."""
    return flash_attention(q, k, v, causal=causal, n_rep=n_rep)
