"""The fused DMM mapping of a whole event chunk in one kernel launch.

Hopper counterpart of the Pallas kernel ``repro.kernels.segmented_gather``:
every (event, block) mapping path of a chunk is one output row of a single
gather (``csrc/segmented_gather.cu``), so a chunk costs one launch however
many blocks and columns it touches.

:func:`segmented_gather` picks by tensor device: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.segmented_gather_ref`.  ``launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .ref import segmented_gather_ref

__all__ = ["segmented_gather", "launches"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = build.load("segmented_gather").metl_segmented_gather
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 5 + [ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
    return fn


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
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"no segmented_gather kernel for device {dev}")
    build.check_operand("values", values, torch.float32, 2, dev)
    build.check_operand("mask", mask, torch.int8, 2, dev)
    build.check_operand("rows", rows, torch.int32, 1, dev)
    build.check_operand("blks", blks, torch.int32, 1, dev)
    build.check_operand("src2d", src2d, torch.int32, 2, dev)
    if mask.shape != values.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != values {tuple(values.shape)}")
    if rows.shape != blks.shape:
        raise ValueError(f"rows {tuple(rows.shape)} != blks {tuple(blks.shape)}")
    (s,), (b, n_in), (n_blocks, w) = rows.shape, values.shape, src2d.shape
    out_v = torch.empty((s, w), dtype=torch.float32, device=dev)
    out_m = torch.empty((s, w), dtype=torch.int8, device=dev)
    if s == 0 or w == 0:
        return out_v, out_m
    if b == 0 or n_in == 0 or n_blocks == 0:
        raise ValueError("segmented_gather needs a non-empty payload and table")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            values.data_ptr(), mask.data_ptr(), rows.data_ptr(),
            blks.data_ptr(), src2d.data_ptr(), out_v.data_ptr(),
            out_m.data_ptr(), s, w, b, n_in, n_blocks, float(fill), stream,
        )
    if err != 0:
        raise RuntimeError(f"segmented_gather launch failed: CUDA error {err}")
    launches += 1
    return out_v, out_m
