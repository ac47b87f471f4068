"""The MoE combine, computed on the router's non-zero weights.

Hopper counterpart of the Pallas kernel ``repro.kernels.moe_combine``
(``csrc/moe_combine.cu``): ``out[t, d] = sum_{e,c} combine[t, e, c] *
expert_out[e, c, d]`` with a float32 accumulator, for float32 or bfloat16
operands of any shape and any density of ``combine``.  No model path calls
it: its entry point is the op :func:`repro_torch.kernels.ops.moe_combine`.

On the card it is two kernels.  The first lists, for each tile of
:data:`TILE_T` tokens, the ``(e, c)`` columns where one of its weights is
non-zero, in ascending order, and flags every column ``d`` of
``expert_out`` that holds an inf or a NaN; the second multiplies each
tile's listed weights by the rows they name, and sums every ``E*C`` column
instead for the :data:`TILE_D` output columns around a flagged one, so
``0 x NaN`` comes out where the dense product puts it.  The wrapper
allocates the scratch (the flags zeroed, the rest sized for a list of
every column) and never reads it back: no host sync.

:func:`moe_combine` takes the kernel's argument order ``(combine,
expert_out)`` and picks by tensor device: on a CUDA tensor it launches the
kernels (or raises), on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.moe_combine_ref`.  ``launches`` counts
kernel launches and nothing else: two a call on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import moe_combine_ref

__all__ = ["moe_combine", "launches", "TILE_T", "TILE_D", "TILE_K"]

launches = 0  # kernel launches, 2 a CUDA call (CPU calls to the plain version not counted)
TILE_T = 16  # tokens a tile's list covers (csrc kBT)
TILE_D = 256  # output columns a product block takes, dense or by its list (csrc kBD)
TILE_K = 32  # terms a product step sums into a partial sum before the total (csrc kBK)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_D = 65535 * TILE_D  # the product grid's y extent times a block's columns


def _fn():
    fn = build.load("moe_combine").metl_moe_combine
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 5 + [_VP]
        fn.restype = ctypes.c_int
    return fn


def moe_combine(combine: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
    """Combine expert outputs: combine (T, E, C), expert_out (E, C, D) ->
    (T, D) in ``expert_out.dtype``, not synchronised.  Each operand is
    float32 or bfloat16, contiguous, on one device."""
    if expert_out.device.type == "cpu":
        return moe_combine_ref(expert_out, combine)
    global launches
    dev = expert_out.device
    if dev.type != "cuda":
        raise ValueError(f"no moe_combine kernel for device {dev}")
    for name, t in (("combine", combine), ("expert_out", expert_out)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or bfloat16")
        build.check_operand(name, t, t.dtype, 3, dev)
    (t, e, c), (e2, c2, d) = combine.shape, expert_out.shape
    if (e, c) != (e2, c2):
        raise ValueError(f"combine {tuple(combine.shape)} does not fit expert_out "
                         f"{tuple(expert_out.shape)}")
    if d > _MAX_D:
        raise ValueError(f"{d} output columns exceed the kernel's grid ({_MAX_D})")
    out = torch.empty((t, d), dtype=expert_out.dtype, device=dev)
    if t == 0 or d == 0:
        return out
    k, n_tiles = e * c, -(-t // TILE_T)
    lists = torch.empty((n_tiles, k), dtype=torch.int32, device=dev)
    weights = torch.empty((n_tiles, k, TILE_T), dtype=torch.float32, device=dev)
    lengths = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    flags = torch.zeros((d,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            combine.data_ptr(), expert_out.data_ptr(), out.data_ptr(), lists.data_ptr(),
            weights.data_ptr(), lengths.data_ptr(), flags.data_ptr(), t, k, d,
            combine.element_size(), expert_out.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_combine launch failed: CUDA error {err}")
    launches += 2
    return out
