"""Device densification fused with the mapping: one launch per packed chunk.

Hopper counterpart of the Pallas kernels ``repro.kernels.densify_map``
(``densify_map`` and its per-shard body ``densify_map_shard``) AND of the
resolve step that fed them (``repro.kernels.ops._resolve_items``): the
kernel (``csrc/densify_map.cu``) unpacks the chunk's single int32 buffer,
resolves each item's uid against the plan's uid tables, and maps every
(event, block) pair through a compare-select over the event's items, one
warp per output row, so the device-densify path stays one launch per chunk
and no dense payload exists anywhere.  :func:`densify_map_shard` does the
same for the shards of the sharded block table that one device holds, all
in one launch, each shard routed by its own section of the packed routing.
:func:`densify_map_chunk` is the engines' route: one C call copies the
chunk from a pinned host arena to the device and launches the kernel.

Each wrapper picks by tensor device: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs the plain version
(:func:`repro_torch.kernels.ref.densify_map_packed_ref` /
:func:`~repro_torch.kernels.ref.densify_map_shard_ref`).  ``launches`` and
``shard_launches`` count each wrapper's kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build
from .ref import densify_map_packed_ref, densify_map_shard_ref, route_offset

__all__ = ["densify_map", "densify_map_shard", "densify_map_chunk", "split_outputs",
           "launches", "shard_launches"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)
shard_launches = 0  # the same, for densify_map_shard

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = build.load("densify_map").metl_densify_map
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 6 + [_I] * 10 + [ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
    return fn


def _chunk_fn():
    fn = build.load("densify_map").metl_densify_map_chunk
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7
        fn.restype = ctypes.c_int
    return fn


_NOT_PINNED = -1  # metl_densify_map_chunk: the host arena is not pinned
# metl_densify_map_chunk's parameter block (int64): the device, the packed
# chunk's bytes and its offset in the device allocation, the sizes, the fill's
# float32 bits; then the copies and launches it issued


def _check_tables(dev, uid_slot, uid_col, table, ndim=3) -> None:
    build.check_operand("uid_slot", uid_slot, torch.int32, 1, dev)
    build.check_operand("uid_col", uid_col, torch.int32, 1, dev)
    build.check_operand("block table", table, torch.int32, ndim, dev)
    if uid_slot.shape != uid_col.shape:
        raise ValueError(
            f"uid_slot {tuple(uid_slot.shape)} != uid_col {tuple(uid_col.shape)}"
        )


def _check_sizes(n_items, n_events, n_rows, k, n_route, shard_lo, n_loc) -> None:
    if min(n_items, n_events, n_rows, k) < 0:
        raise ValueError("section sizes must be non-negative")
    if shard_lo < 0 or shard_lo + n_loc > n_route:
        raise ValueError(f"shards [{shard_lo}, {shard_lo + n_loc}) outside the "
                         f"routing's {n_route}")


def _launch(name, packed, uid_slot, uid_col, table, *, n_items, n_events, n_rows,
            k, n_route, shard_lo, fill):
    """Check the operands of wrapper ``name`` and map ``table``'s shards,
    (n_loc, n_blocks, W), in one launch, routed by sections ``shard_lo`` ..
    of the ``n_route`` shards' routing in ``packed``.  Returns the (n_loc,
    n_rows, W) outputs and whether the kernel launched (not for an empty
    output)."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    build.check_operand("packed", packed, torch.int32, 1, dev)
    _check_tables(dev, uid_slot, uid_col, table)
    need = route_offset(n_items, n_events) + 2 * n_route * n_rows
    if packed.numel() < need:
        raise ValueError(f"packed holds {packed.numel()} int32, layout needs {need}")
    n_loc, n_blocks, w = table.shape
    _check_sizes(n_items, n_events, n_rows, k, n_route, shard_lo, n_loc)
    out_v = torch.empty((n_loc, n_rows, w), dtype=torch.float32, device=dev)
    out_m = torch.empty((n_loc, n_rows, w), dtype=torch.int8, device=dev)
    if n_loc == 0 or n_rows == 0 or w == 0:
        return out_v, out_m, False
    if n_items == 0 or n_events == 0 or n_blocks == 0:
        raise ValueError(f"{name} needs items, events and a non-empty table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            packed.data_ptr(), uid_slot.data_ptr(), uid_col.data_ptr(),
            table.data_ptr(), out_v.data_ptr(), out_m.data_ptr(),
            n_items, n_events, n_rows, k, uid_slot.numel(), w, n_blocks,
            n_route, shard_lo, n_loc, float(fill), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_v, out_m, True


def densify_map(
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
    """Resolve, densify and map one packed chunk in one launch.

    ``packed`` is the int32 buffer ``[uids(n_items) | val_bits(n_items) |
    starts(n_events) | counts(n_events) | ev_col(n_events) | rows(n_rows) |
    blks(n_rows)]``; ``k`` is the largest number of items an event may
    contribute; ``uid_slot`` / ``uid_col`` are the plan's int32 uid tables
    and ``src2d`` its (n_blocks, W) block table.  Returns ((n_rows, W)
    float32 values, (n_rows, W) int8 mask), not synchronised.
    """
    if packed.device.type == "cpu":
        return densify_map_packed_ref(
            packed, uid_slot, uid_col, src2d, n_items=n_items,
            n_events=n_events, n_rows=n_rows, k=k, fill=fill,
        )
    global launches
    if src2d.dim() != 2:
        raise ValueError(f"src2d has {src2d.dim()} dims, expected 2")
    out_v, out_m, launched = _launch(
        "densify_map", packed, uid_slot, uid_col, src2d[None], n_items=n_items,
        n_events=n_events, n_rows=n_rows, k=k, n_route=1, shard_lo=0, fill=fill,
    )
    launches += launched
    return out_v[0], out_m[0]


def densify_map_shard(
    packed: torch.Tensor,
    uid_slot: torch.Tensor,
    uid_col: torch.Tensor,
    src3d: torch.Tensor,
    *,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    n_shards: int,
    shard_lo: int = 0,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve, densify and map one packed chunk of the sharded path for the
    shards ``[shard_lo, shard_lo + len(src3d))`` that one device holds, in
    one launch.

    ``packed`` is ``[uids(n_items) | val_bits(n_items) | starts(n_events) |
    counts(n_events) | ev_col(n_events) | rows(n_shards, n_rows) |
    blks(n_shards, n_rows)]``: all ``n_shards`` shards' routing, blocks
    local to each shard; ``src3d`` is (n_loc, n_blocks_loc, W) int32, the
    table slices of this device's shards.  Returns ((n_loc, n_rows, W)
    float32 values, (n_loc, n_rows, W) int8 mask), not synchronised:
    ``out[z]`` is :func:`densify_map` routed by shard ``shard_lo + z``
    through ``src3d[z]``.
    """
    if packed.device.type == "cpu":
        return densify_map_shard_ref(
            packed, uid_slot, uid_col, src3d, n_items=n_items, n_events=n_events,
            n_rows=n_rows, k=k, n_shards=n_shards, shard_lo=shard_lo, fill=fill,
        )
    global shard_launches
    out_v, out_m, launched = _launch(
        "densify_map_shard", packed, uid_slot, uid_col, src3d, n_items=n_items,
        n_events=n_events, n_rows=n_rows, k=k, n_route=n_shards, shard_lo=shard_lo,
        fill=fill,
    )
    shard_launches += launched
    return out_v, out_m


def split_outputs(raw, n_loc: int, n_rows: int, width: int):
    """The (n_loc, n_rows, W) float32 values and int8 mask at the start of a
    chunk's output allocation ``raw`` (uint8, a tensor or a numpy array:
    all values, then all masks), as views of it."""
    n = n_loc * n_rows * width
    f32, i8 = ((np.float32, np.int8) if isinstance(raw, np.ndarray)
               else (torch.float32, torch.int8))
    return (raw[: 4 * n].view(f32).reshape(n_loc, n_rows, width),
            raw[4 * n : 5 * n].view(i8).reshape(n_loc, n_rows, width))


def densify_map_chunk(
    host: torch.Tensor,
    uid_slot: torch.Tensor,
    uid_col: torch.Tensor,
    table: torch.Tensor,
    *,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    n_route: int = 1,
    shard_lo: int = 0,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, int, int]:
    """Send one packed chunk from a host arena to ``table``'s device and map
    it there: the engines' route, one C call for the copy and the launch.

    ``host`` is a uint8 CPU arena whose first bytes hold the packed chunk
    (the layout of :func:`densify_map_shard`, routed over ``n_route``
    shards; :func:`densify_map`'s for ``n_route`` 1); ``table`` is the
    (n_loc, n_blocks, W) table stack of shards ``[shard_lo, shard_lo +
    n_loc)``, or one (n_blocks, W) table.  On a CUDA device ``host`` must be
    pinned, and the caller keeps it unchanged until the copy has run (an
    event recorded after this call); on the CPU the chunk is copied and the
    plain version maps it.  Returns ``(out, copies, launches)``: one uint8
    allocation that starts with the (n_loc, n_rows, W) outputs
    (:func:`split_outputs`), not synchronised, and how many copies and
    launches (plain-version calls on the CPU) were issued.  ``launches``
    (``n_route`` 1) or ``shard_launches`` counts the launches.
    """
    global launches, shard_launches
    n_bytes = 4 * (route_offset(n_items, n_events) + 2 * n_route * n_rows)
    build.check_arena(host, n_bytes)
    dev = table.device
    n_blocks, w = table.shape[-2:]
    n_loc = table.shape[0] if table.dim() == 3 else 1
    n = n_loc * n_rows * w
    if dev.type == "cpu":
        packed = host[:n_bytes].clone().view(torch.int32)  # the copy
        out = torch.empty(5 * n, dtype=torch.uint8)
        for dst, src in zip(split_outputs(out, n_loc, n_rows, w), densify_map_shard_ref(
                packed, uid_slot, uid_col, table.view(n_loc, n_blocks, w), n_items=n_items,
                n_events=n_events, n_rows=n_rows, k=k, n_shards=n_route, shard_lo=shard_lo,
                fill=fill)):
            dst.copy_(src)
        return out, 1, int(n > 0)
    if dev.type != "cuda":
        raise ValueError(f"no densify_map kernel for device {dev}")
    if table.dim() not in (2, 3):
        raise ValueError(f"block table has {table.dim()} dims, expected 2 or 3")
    _check_tables(dev, uid_slot, uid_col, table, table.dim())
    _check_sizes(n_items, n_events, n_rows, k, n_route, shard_lo, n_loc)
    if n and (n_items == 0 or n_events == 0 or n_blocks == 0):
        raise ValueError("densify_map needs items, events and a non-empty table")
    # one allocation: the outputs, then (16-byte aligned) the packed chunk,
    # which lives as long as the outputs do
    at = -(-5 * n // 16) * 16
    out = torch.empty(at + n_bytes, dtype=torch.uint8, device=dev)
    params = np.array([dev.index, n_bytes, at, n_items, n_events, n_rows, k,
                       uid_slot.numel(), w, n_blocks, n_route, shard_lo, n_loc,
                       int(np.float32(fill).view(np.int32)), 0, 0], dtype=np.int64)
    err = _chunk_fn()(
        host.data_ptr(), out.data_ptr(), uid_slot.data_ptr(), uid_col.data_ptr(),
        table.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, params.ctypes.data,
    )
    copies, launched = int(params[-2]), int(params[-1])
    if n_route == 1:
        launches += launched
    else:
        shard_launches += launched
    if err == _NOT_PINNED:
        raise ValueError("a CUDA dispatch needs a pinned host arena")
    if err != 0:
        raise RuntimeError(f"densify_map chunk failed: CUDA error {err} after "
                           f"{copies} copies and {launched} launches")
    return out, copies, launched
