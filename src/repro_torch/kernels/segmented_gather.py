"""The fused DMM mapping of a whole event chunk in one kernel launch.

Hopper counterpart of the Pallas kernels ``repro.kernels.segmented_gather``
(``segmented_gather`` and its per-shard body ``segmented_gather_shard``):
every (event, block) mapping path of a chunk is one output row of a single
gather (``csrc/segmented_gather.cu``), so a chunk costs one launch however
many blocks and columns it touches.  :func:`segmented_gather_shard` maps the
shards of the sharded block table that one device holds, all in that one
launch (the shard is a grid axis of the same kernel body).

Each wrapper picks by tensor device: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs the plain version
(:func:`repro_torch.kernels.ref.segmented_gather_ref` /
:func:`~repro_torch.kernels.ref.segmented_gather_shard_ref`).  ``launches``
and ``shard_launches`` count each wrapper's kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .ref import segmented_gather_ref, segmented_gather_shard_ref

__all__ = ["segmented_gather", "segmented_gather_shard", "launches", "shard_launches"]

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
