"""The DMM mapping of one compacted block: a batched masked gather.

Hopper counterpart of the Pallas kernel ``repro.kernels.masked_gather`` (the
paper's Algorithm 6): ``out[b, q] = values[b, src[q]]`` where ``src[q] >= 0``
and the gathered mask is set, else ``fill`` (``csrc/masked_gather.cu``).  The
per-block engine launches it once per block of each (schema, version) group.

:func:`masked_gather` picks by tensor device: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.masked_gather_ref`.  ``launches`` counts
kernel launches and nothing else.  :func:`masked_gather_blocks` maps a
whole per-block chunk (:class:`~repro_torch.kernels.blocks.BlockChunk`) in
one call: the library's launcher issues every group's copies and every
block's launch of the same kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .blocks import BlockChunk, apply_blocks
from .ref import masked_gather_ref

__all__ = ["masked_gather", "masked_gather_blocks", "launches", "value_operands"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_VALUE_DTYPES = (torch.float32, torch.bfloat16)


def _fn():
    fn = build.load("masked_gather").metl_masked_gather
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5 + [_I] * 4 + [ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
    return fn


def value_operands(name: str, values: torch.Tensor, mask: torch.Tensor,
                   src: torch.Tensor) -> torch.device:
    """The checks both per-block kernels make before a launch: float32 or
    bfloat16 ``values`` (B, N_in), int8 ``mask`` of the same shape, int32
    ``src`` (N_out,), all contiguous on one CUDA device, which is returned."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"values has dtype {values.dtype}, expected float32 or bfloat16")
    build.check_operand("values", values, values.dtype, 2, dev)
    build.check_operand("mask", mask, torch.int8, 2, dev)
    build.check_operand("src", src, torch.int32, 1, dev)
    if mask.shape != values.shape:
        raise ValueError(f"mask {tuple(mask.shape)} != values {tuple(values.shape)}")
    return dev


def masked_gather(
    values: torch.Tensor,
    mask: torch.Tensor,
    src: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one compacted block to a batch of dense messages.

    values: (B, N_in) float32 or bfloat16, mask: (B, N_in) int8, src:
    (N_out,) int32 (-1 = null).  Any N_in and any N_out (the reference's
    N_out % 128 tiling constraint is lifted).  Returns ((B, N_out) values in
    ``values.dtype``, (B, N_out) int8 mask), not synchronised.
    """
    if values.device.type == "cpu":
        return masked_gather_ref(values, mask, src, fill=fill)
    global launches
    dev = value_operands("masked_gather", values, mask, src)
    (b, n_in), (n_out,) = values.shape, src.shape
    out_v = torch.empty((b, n_out), dtype=values.dtype, device=dev)
    out_m = torch.empty((b, n_out), dtype=torch.int8, device=dev)
    if b == 0 or n_out == 0:
        return out_v, out_m
    if n_in == 0:
        raise ValueError("masked_gather needs a non-empty payload")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            values.data_ptr(), mask.data_ptr(), src.data_ptr(), out_v.data_ptr(),
            out_m.data_ptr(), b, n_in, n_out, values.element_size(), float(fill),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"masked_gather launch failed: CUDA error {err}")
    launches += 1
    return out_v, out_m


def masked_gather_blocks(
    chunk: BlockChunk, src_flat: torch.Tensor, *, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Every block of a per-block chunk through :func:`masked_gather`'s
    kernel, on ``src_flat``'s device (the plain version on the CPU); see
    :func:`repro_torch.kernels.blocks.apply_blocks`.  Returns ``(out_v,
    out_m, copies, launches)``; ``launches`` counts the launcher's launches."""
    global launches
    out = apply_blocks("masked_gather", masked_gather_ref, chunk, src_flat, fill=fill)
    if src_flat.device.type == "cuda":
        launches += out[3]
    return out
