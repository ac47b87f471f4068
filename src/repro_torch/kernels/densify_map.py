"""Device densification fused with the mapping: one launch per packed chunk.

Hopper counterpart of the Pallas kernel ``repro.kernels.densify_map`` AND of
the resolve step that fed it (``repro.kernels.ops._resolve_items``): the
kernel (``csrc/densify_map.cu``) unpacks the chunk's single int32 buffer,
resolves each item's uid against the plan's uid tables in its prologue, and
maps every (event, block) pair through a compare-select over the event's
items, so the device-densify path stays one launch per chunk and no dense
payload exists anywhere.

:func:`densify_map` picks by tensor device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.densify_map_packed_ref`.  ``launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .ref import densify_map_packed_ref, route_offset

__all__ = ["densify_map", "launches"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = build.load("densify_map").metl_densify_map
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 6 + [_I] * 7 + [ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
    return fn


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
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"no densify_map kernel for device {dev}")
    build.check_operand("packed", packed, torch.int32, 1, dev)
    build.check_operand("uid_slot", uid_slot, torch.int32, 1, dev)
    build.check_operand("uid_col", uid_col, torch.int32, 1, dev)
    build.check_operand("src2d", src2d, torch.int32, 2, dev)
    if uid_slot.shape != uid_col.shape:
        raise ValueError(
            f"uid_slot {tuple(uid_slot.shape)} != uid_col {tuple(uid_col.shape)}"
        )
    need = route_offset(n_items, n_events) + 2 * n_rows
    if packed.numel() < need:
        raise ValueError(f"packed holds {packed.numel()} int32, layout needs {need}")
    if min(n_items, n_events, n_rows, k) < 0:
        raise ValueError("section sizes must be non-negative")
    n_blocks, w = src2d.shape
    out_v = torch.empty((n_rows, w), dtype=torch.float32, device=dev)
    out_m = torch.empty((n_rows, w), dtype=torch.int8, device=dev)
    if n_rows == 0 or w == 0:
        return out_v, out_m
    if n_items == 0 or n_events == 0 or n_blocks == 0:
        raise ValueError("densify_map needs items, events and a non-empty table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            packed.data_ptr(), uid_slot.data_ptr(), uid_col.data_ptr(),
            src2d.data_ptr(), out_v.data_ptr(), out_m.data_ptr(),
            n_items, n_events, n_rows, k, uid_slot.numel(), w, n_blocks,
            float(fill), stream,
        )
    if err != 0:
        raise RuntimeError(f"densify_map launch failed: CUDA error {err}")
    launches += 1
    return out_v, out_m
