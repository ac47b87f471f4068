"""One compacted block applied as an explicit 0/1 matrix: the paper's
pre-DMM baseline.

Hopper counterpart of the Pallas kernel ``repro.kernels.onehot_map``: the
kernel (``csrc/onehot_map.cu``) forms each output column's one-hot vector
from ``src`` on the fly and contracts the staged payload rows through it in
IEEE float32 FFMA, ``out_v = vals @ M.T`` and ``out_m = mask @ M.T > 0.5``.
It serves the per-block engine's ``impl="onehot"``, the A/B against the
compacted gather (:mod:`repro_torch.kernels.masked_gather`).

:func:`onehot_map` picks by tensor device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.onehot_map_ref`.  ``launches`` counts kernel
launches and nothing else.  :func:`onehot_map_blocks` maps a whole
per-block chunk in one call, as
:func:`~repro_torch.kernels.masked_gather.masked_gather_blocks` does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .blocks import BlockChunk, apply_blocks
from .masked_gather import value_operands
from .ref import onehot_map_ref

__all__ = ["onehot_map", "onehot_map_blocks", "launches"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = build.load("onehot_map").metl_onehot_map
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5 + [_I] * 4 + [ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
    return fn


def onehot_map(
    values: torch.Tensor,
    mask: torch.Tensor,
    src: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`repro_torch.kernels.masked_gather.
    masked_gather`; the values are contracted in float32 and stored in
    ``values.dtype``.  Not synchronised."""
    if values.device.type == "cpu":
        return onehot_map_ref(values, mask, src, fill=fill)
    global launches
    dev = value_operands("onehot_map", values, mask, src)
    (b, n_in), (n_out,) = values.shape, src.shape
    out_v = torch.empty((b, n_out), dtype=values.dtype, device=dev)
    out_m = torch.empty((b, n_out), dtype=torch.int8, device=dev)
    if b == 0 or n_out == 0:
        return out_v, out_m
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            values.data_ptr(), mask.data_ptr(), src.data_ptr(), out_v.data_ptr(),
            out_m.data_ptr(), b, n_in, n_out, values.element_size(), float(fill),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"onehot_map launch failed: CUDA error {err}")
    launches += 1
    return out_v, out_m


def onehot_map_blocks(
    chunk: BlockChunk, src_flat: torch.Tensor, *, fill: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Every block of a per-block chunk through :func:`onehot_map`'s kernel,
    as :func:`~repro_torch.kernels.masked_gather.masked_gather_blocks`."""
    global launches
    out = apply_blocks("onehot_map", onehot_map_ref, chunk, src_flat, fill=fill)
    if src_flat.device.type == "cuda":
        launches += out[3]
    return out
