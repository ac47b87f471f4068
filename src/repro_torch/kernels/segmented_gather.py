"""The fused DMM mapping of a whole event chunk in one kernel launch.

Hopper counterpart of the Pallas kernels ``repro.kernels.segmented_gather``
(``segmented_gather`` and its per-shard body ``segmented_gather_shard``):
every (event, block) mapping path of a chunk is one output row of a single
gather (``csrc/segmented_gather.cu``, one warp per output row), so a chunk
costs one launch however many blocks and columns it touches.
:func:`segmented_gather_shard` maps the shards of the sharded block table
that one device holds, all in that one launch (the shard is a grid axis of
the same kernel body).  :func:`segmented_gather_chunk` is the engines'
route: one C call copies a host-densified chunk's four operands from a
pinned host arena (laid out by :func:`arena_layout`) to the device and
launches the kernel.

Each wrapper picks by tensor device: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs the plain version
(:func:`repro_torch.kernels.ref.segmented_gather_ref` /
:func:`~repro_torch.kernels.ref.segmented_gather_shard_ref`).  ``launches``
and ``shard_launches`` count each wrapper's kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import build
from .densify_map import split_outputs
from .ref import segmented_gather_ref, segmented_gather_shard_ref

__all__ = ["segmented_gather", "segmented_gather_shard", "segmented_gather_chunk",
           "arena_layout", "arena_views", "launches", "shard_launches"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)
shard_launches = 0  # the same, for segmented_gather_shard

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = build.load("segmented_gather").metl_segmented_gather
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 6 + [ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
    return fn


def _chunk_fn():
    fn = build.load("segmented_gather").metl_segmented_gather_chunk
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5
        fn.restype = ctypes.c_int
    return fn


_NOT_PINNED = -1  # metl_segmented_gather_chunk: the host arena is not pinned
# metl_segmented_gather_chunk's parameter block (int64): the device, the
# arena's offset in the device allocation and the four operands' offsets in
# the arena, the sizes, the fill's float32 bits; then the copies and launches
# it issued


def _launch(name, values, mask, rows, blks, table, fill):
    """Check the operands of wrapper ``name`` and map ``table``'s shards in
    one launch: rows/blks (n_shards, S), table (n_shards, n_blocks, W).
    Returns the (n_shards, S, W) outputs and whether the kernel launched
    (not for an empty output)."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    build.check_operand("values", values, torch.float32, 2, dev)
    build.check_operand("mask", mask, torch.int8, 2, dev)
    for arg, t, nd in (("rows", rows, 2), ("blks", blks, 2), ("block table", table, 3)):
        build.check_operand(arg, t, torch.int32, nd, dev)
    if mask.shape != values.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != values {tuple(values.shape)}")
    if rows.shape != blks.shape or rows.shape[0] != table.shape[0]:
        raise ValueError(f"rows {tuple(rows.shape)}, blks {tuple(blks.shape)} and the "
                         f"block table {tuple(table.shape)} disagree")
    (n_sh, s), (b, n_in), (_, n_blocks, w) = rows.shape, values.shape, table.shape
    out_v = torch.empty((n_sh, s, w), dtype=torch.float32, device=dev)
    out_m = torch.empty((n_sh, s, w), dtype=torch.int8, device=dev)
    if n_sh == 0 or s == 0 or w == 0:
        return out_v, out_m, False
    if b == 0 or n_in == 0 or n_blocks == 0:
        raise ValueError(f"{name} needs a non-empty payload and table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            values.data_ptr(), mask.data_ptr(), rows.data_ptr(),
            blks.data_ptr(), table.data_ptr(), out_v.data_ptr(),
            out_m.data_ptr(), n_sh, s, w, b, n_in, n_blocks, float(fill), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_v, out_m, True


def segmented_gather(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src2d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map every (event, block) pair of a chunk in one launch.

    values: (B, N_in) float32, mask: (B, N_in) int8, rows/blks: (S,) int32,
    src2d: (n_blocks, W) int32.  Returns ((S, W) float32 values, (S, W) int8
    mask); output row ``s`` is event row ``rows[s]`` mapped through block
    ``blks[s]``.  The outputs are not synchronised.
    """
    if values.device.type == "cpu":
        return segmented_gather_ref(values, mask, rows, blks, src2d, fill=fill)
    global launches
    for arg, t, nd in (("rows", rows, 1), ("blks", blks, 1), ("src2d", src2d, 2)):
        if t.dim() != nd:
            raise ValueError(f"{arg} has {t.dim()} dims, expected {nd}")
    out_v, out_m, launched = _launch("segmented_gather", values, mask, rows[None],
                                     blks[None], src2d[None], fill)
    launches += launched
    return out_v[0], out_m[0]


def segmented_gather_shard(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src3d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map each shard's routing through its own slice of the block table,
    every shard in one launch.

    values: (B, N_in) float32 and mask: (B, N_in) int8, shared by the
    shards; rows/blks: (n_shards, S_loc) int32, shard-local block ids;
    src3d: (n_shards, n_blocks_loc, W) int32.  Returns ((n_shards, S_loc, W)
    float32 values, (n_shards, S_loc, W) int8 mask), not synchronised:
    ``out[z]`` is :func:`segmented_gather` of ``rows[z]``, ``blks[z]``
    through ``src3d[z]``.
    """
    if values.device.type == "cpu":
        return segmented_gather_shard_ref(values, mask, rows, blks, src3d, fill=fill)
    global shard_launches
    out_v, out_m, launched = _launch("segmented_gather_shard", values, mask, rows, blks,
                                     src3d, fill)
    shard_launches += launched
    return out_v, out_m


def arena_layout(n_events: int, n_in: int, n_route: int,
                 n_rows: int) -> Tuple[Tuple[int, int, int, int], int]:
    """Where a host-densified chunk's four operands lie in its arena: the
    byte offsets of values (n_events, n_in) float32, mask (n_events, n_in)
    int8, rows and blks (n_route, n_rows) int32, each 16-byte aligned, and
    the bytes the four span."""
    at, o = [], 0
    for n in (4 * n_events * n_in, n_events * n_in, 4 * n_route * n_rows,
              4 * n_route * n_rows):
        at.append(o)
        o += -(-n // 16) * 16
    return tuple(at), o


def arena_views(arena, n_events: int, n_in: int, n_route: int, n_rows: int):
    """The four operands in ``arena`` (uint8, a tensor or a numpy array, at
    least :func:`arena_layout`'s bytes) as views of it: values, mask, rows,
    blks."""
    (va, ma, ra, ba), _ = arena_layout(n_events, n_in, n_route, n_rows)
    f32, i8, i32 = ((np.float32, np.int8, np.int32) if isinstance(arena, np.ndarray)
                    else (torch.float32, torch.int8, torch.int32))
    n, m = n_events * n_in, n_route * n_rows
    return (arena[va : va + 4 * n].view(f32).reshape(n_events, n_in),
            arena[ma : ma + n].view(i8).reshape(n_events, n_in),
            arena[ra : ra + 4 * m].view(i32).reshape(n_route, n_rows),
            arena[ba : ba + 4 * m].view(i32).reshape(n_route, n_rows))


def segmented_gather_chunk(
    host: torch.Tensor,
    table: torch.Tensor,
    *,
    n_events: int,
    n_in: int,
    n_rows: int,
    n_route: int = 1,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, int, int]:
    """Send one host-densified chunk from its arena to ``table``'s device
    and map it there: the engines' route, one C call for the four copies
    and the launch.

    ``host`` is a uint8 CPU arena holding values (n_events, n_in) float32,
    mask (n_events, n_in) int8 and the routing, rows and shard-local blks
    (n_route, n_rows) int32, at the offsets of :func:`arena_layout`;
    ``table`` is the (n_route, n_blocks, W) table stack of every shard, or
    one (n_blocks, W) table (``n_route`` 1).  On a CUDA device ``host`` must
    be pinned, and the caller keeps it unchanged until the copies have run
    (an event recorded after this call); on the CPU the operands are copied
    and the plain version maps them.  Returns ``(out, copies, launches)``:
    one uint8 allocation that starts with the (n_route, n_rows, W) outputs
    (:func:`~repro_torch.kernels.densify_map.split_outputs`), not
    synchronised, and how many copies and launches (plain-version calls on
    the CPU) were issued.  ``launches`` (``n_route`` 1) or
    ``shard_launches`` counts the launches.
    """
    global launches, shard_launches
    at, n_bytes = arena_layout(n_events, n_in, n_route, n_rows)
    build.check_arena(host, n_bytes)
    if table.dim() not in (2, 3):
        raise ValueError(f"block table has {table.dim()} dims, expected 2 or 3")
    dev = table.device
    n_blocks, w = table.shape[-2:]
    n_loc = table.shape[0] if table.dim() == 3 else 1
    if n_loc != n_route:
        raise ValueError(f"{n_loc} table slices for a chunk routed over {n_route} shards")
    n = n_route * n_rows * w
    if dev.type == "cpu":
        v, m, r, b = arena_views(host[:n_bytes].clone(), n_events, n_in, n_route,
                                 n_rows)  # the four copies
        out = torch.empty(5 * n, dtype=torch.uint8)
        for dst, src in zip(split_outputs(out, n_route, n_rows, w),
                            segmented_gather_shard_ref(
                                v, m, r, b, table.view(n_route, n_blocks, w), fill=fill)):
            dst.copy_(src)
        return out, 4, int(n > 0)
    if dev.type != "cuda":
        raise ValueError(f"no segmented_gather kernel for device {dev}")
    build.check_operand("block table", table, torch.int32, table.dim(), dev)
    if n and (n_events == 0 or n_in == 0 or n_blocks == 0):
        raise ValueError("segmented_gather needs a non-empty payload and table")
    # one allocation: the outputs, then (16-byte aligned) the arena's image,
    # which lives as long as the outputs do
    image_at = -(-5 * n // 16) * 16
    out = torch.empty(image_at + n_bytes, dtype=torch.uint8, device=dev)
    params = np.array([dev.index, image_at, *at, n_route, n_rows, w, n_events, n_in,
                       n_blocks, int(np.float32(fill).view(np.int32)), 0, 0],
                      dtype=np.int64)
    err = _chunk_fn()(host.data_ptr(), out.data_ptr(), table.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream, params.ctypes.data)
    copies, launched = int(params[-2]), int(params[-1])
    if n_route == 1:
        launches += launched
    else:
        shard_launches += launched
    if err == _NOT_PINNED:
        raise ValueError("a CUDA dispatch needs a pinned host arena")
    if err != 0:
        raise RuntimeError(f"segmented_gather chunk failed: CUDA error {err} after "
                           f"{copies} copies and {launched} launches")
    return out, copies, launched
