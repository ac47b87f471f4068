"""The MoE combine as one tiled product.

Hopper counterpart of the Pallas kernel ``repro.kernels.moe_combine``
(``csrc/moe_combine.cu``): ``out[t, d] = sum_{e,c} combine[t, e, c] *
expert_out[e, c, d]`` with a float32 accumulator, for float32 or bfloat16
operands of any shape (the reference pads every axis to its tiles; the
kernel masks the ragged edges).  No model path calls it: its entry point is
the op :func:`repro_torch.kernels.ops.moe_combine`.

:func:`moe_combine` takes the kernel's argument order ``(combine,
expert_out)`` and picks by tensor device: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs the plain version
:func:`repro_torch.kernels.ref.moe_combine_ref`.  ``launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import moe_combine_ref

__all__ = ["moe_combine", "launches"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_T = 65535 * 64  # the grid's y extent times the block's rows


def _fn():
    fn = build.load("moe_combine").metl_moe_combine
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 3 + [_I] * 5 + [_VP]
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
    if t > _MAX_T:
        raise ValueError(f"{t} tokens exceed the kernel's grid ({_MAX_T})")
    out = torch.empty((t, d), dtype=expert_out.dtype, device=dev)
    if t == 0 or d == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            combine.data_ptr(), expert_out.data_ptr(), out.data_ptr(), t, e * c, d,
            combine.element_size(), expert_out.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_combine launch failed: CUDA error {err}")
    launches += 1
    return out
