"""Forward attention with an online softmax: the flash kernel.

Hopper counterpart of the Pallas kernel ``repro.kernels.flash_attention``
(``csrc/flash_attention.cu``): q (N, S, hd) against k, v (N / n_rep, T, hd),
query head ``h`` reading KV head ``h // n_rep``, causal or not, float32 or
bfloat16.  It computes what the oracle
:func:`repro_torch.kernels.ref.attention_ref` computes, for any S, T and
``hd <= 128`` (the reference kernel's ``T % block_k`` rule for non-causal
attention is lifted, and keys past T never count when S > T).  The model's
prefill (``attn_impl="pallas"``) launches it once per layer.

:func:`flash_attention` picks by tensor device: on a CUDA tensor it launches
a kernel (or raises), on a CPU tensor it runs the plain version.  On the
card :func:`kernel_variant` picks one of the library's two kernels by dtype
and head dim alone: ``"wgmma"`` (both products on the tensor cores, p
rounded to bfloat16 before p.v) for bfloat16 whose head dim is a multiple
of 8 (TMA's 16-byte row pitch), ``"ffma"`` (float32 FFMA on the CUDA cores,
p kept in float32) for float32 and for bfloat16 of any other head dim.
The wgmma kernel's tensor maps also need q, k and v to start 16-byte
aligned; a call whose operands do not (a view into a larger tensor) raises
rather than take the other kernel.  A launch error raises; nothing falls
back.  ``launches`` counts kernel launches of either kind and nothing
else.

The kernel has no backward, as the reference's has none: a CUDA call with
grad mode on and q, k or v requiring grad raises ``NotImplementedError``
before any launch, rather than return a tensor cut off from the graph.
The plain version on CPU tensors stays differentiable, as the reference's
CPU path is.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import attention_ref

__all__ = ["flash_attention", "kernel_variant", "launches", "MAX_HEAD_DIM"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)
MAX_HEAD_DIM = 128  # the widest head the kernel's shared-memory tiles take
_MAX_HEADS = 65535  # the grid's y extent

_VP = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_TMA_ALIGN = 16  # bytes: a tensor map's base address and row pitch


def _fn():
    fn = build.load("flash_attention").metl_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 4 + [_I] * 8 + [_VP]
        fn.restype = ctypes.c_int
    return fn


def kernel_variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel a CUDA call of this dtype and head dim runs: ``"wgmma"``
    for bfloat16 with ``hd % 8 == 0``, else ``"ffma"``."""
    return "wgmma" if dtype == torch.bfloat16 and hd % 8 == 0 else "ffma"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    n_rep: int = 1,
) -> torch.Tensor:
    """Attention of q (N, S, hd) over k, v (N // n_rep, T, hd).

    All three of one dtype (float32 or bfloat16), contiguous, on one
    device.  Returns (N, S, hd) in ``q.dtype``, not synchronised.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, n_rep=n_rep)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "the reference's flash_attention has no backward; train with attn_impl "
            "'dense' or 'chunked'")
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_operand(name, t, q.dtype, 3, dev)
    (n, s, hd), (nk, t, hd_k) = q.shape, k.shape
    if v.shape != k.shape or hd_k != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if n_rep < 1 or nk * n_rep != n:
        raise ValueError(f"{n} query heads != {nk} KV heads x n_rep {n_rep}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside the kernel's 1..{MAX_HEAD_DIM}")
    if n > _MAX_HEADS:
        raise ValueError(f"{n} query heads exceed the kernel's grid ({_MAX_HEADS})")
    out = torch.empty_like(q)
    if n == 0 or s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention needs at least one key")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    wgmma = kernel_variant(q.dtype, hd) == "wgmma"
    if wgmma and any(p % _TMA_ALIGN for p in ptrs):
        raise ValueError(f"the bfloat16 kernel needs q, k and v {_TMA_ALIGN}-byte aligned; "
                         "pass copies (.clone())")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(
            *ptrs, out.data_ptr(), n, s, t, hd, n_rep, int(causal), q.element_size(),
            int(wgmma), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
