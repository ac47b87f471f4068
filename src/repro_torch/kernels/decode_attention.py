"""Decode attention: one query token a row against its layer's KV cache.

``csrc/decode_attention.cu``: q (B, H, hd) against k, v (B, T, KV, hd),
query head ``h`` reading KV head ``h // (H / KV)``, over the first
``n_valid`` slots alone; float32 or bfloat16, the scores, softmax and p.v
sums in float32, the output (B, H, hd) rounded once to q's dtype.  The
model's decode (:func:`repro_torch.models.attention.attention_decode`, and
:func:`~repro_torch.models.attention.cross_attention`'s one-token step)
calls it once a layer on the card.

It replaces no TPU kernel: the reference decodes with a plain einsum over
the whole cache and a mask of the slots past the position
(``repro.models.attention.attention_decode``), and so did the port.  On the
card that einsum copies every slot of K and V into the product's layout, a
layer a step, whatever the position: ~95 % of an olmo-1b step over a
2,048-slot cache.  The kernel reads the valid slots once, where they lie
(through the cache's strides), so a step needs the bytes of its valid slots
and no more; it is bound by those bytes (see the source's note).

:func:`decode_attention` picks by tensor device: on a CUDA tensor it
launches the kernel (or raises), on a CPU tensor it runs the plain version
:func:`~repro_torch.kernels.ref.decode_attention_ref`, the same function in
float32.  On the card the slots split over several blocks of a (row, KV
head) pair when there are too few pairs to fill the card
(:func:`plan_splits`); a second kernel then joins the splits' partial
softmaxes.  ``launches`` counts kernel launches
and nothing else: 1 a call with one split, 2 with several.

The kernel has no backward: a CUDA call with grad mode on and an input
requiring grad raises ``NotImplementedError`` before any launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref", "check_operands", "kernel_strides",
           "plan_splits", "sm_count", "launches", "TILE", "MAX_HEAD_DIM", "MAX_GROUP"]

launches = 0  # kernel launches (CPU calls to the plain version not counted)
TILE = 64  # slots a block reads a step (csrc kTile); a split covers whole tiles
MAX_HEAD_DIM = 128  # the widest head the kernel's tiles take
MAX_GROUP = 16  # the most query heads that share a KV head (csrc kMaxGroup)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = (torch.float32, torch.bfloat16)
_ALIGN = 16  # bytes: a cp.async copy's source and destination
_MAX_GRID = 65535  # the grid's y and z extents (KV heads, rows)


def _fn():
    fn = build.load("decode_attention").metl_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5 + [_L] * 8 + [_I] * 7 + [_VP]
        fn.restype = ctypes.c_int
    return fn


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int) -> None:
    """What every call takes, on any device: q (B, H, hd), k and v (B, T,
    KV, hd) of one dtype (float32 or bfloat16) and device, H a multiple of
    KV, and ``1 <= n_valid <= T``."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v have dtypes {q.dtype}, {k.dtype}, {v.dtype}; expected one")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, hd) and k, v (B, T, KV, hd); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    (B, H, hd), (Bk, T, KV, hdk) = q.shape, k.shape
    if Bk != B or hdk != hd or KV < 1 or H % KV:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}; expected one")
    if not isinstance(n_valid, int) or not 1 <= n_valid <= T:
        raise ValueError(f"n_valid {n_valid!r} outside 1..{T}")


def kernel_strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The strides the kernel reads q (B, H, hd) and k, v (B, T, KV, hd)
    through, in elements: (q's row and head, k's row, slot and head, v's
    row, slot and head).  Raises for a layout the kernel cannot take: a
    head dim that is not contiguous, wider than 128 or not a whole number of
    16-byte chunks, more than 16 query heads to a KV head, or an operand
    whose head rows do not all start 16-byte aligned."""
    (B, H, hd), KV = q.shape, k.shape[2]
    size = q.element_size()
    if hd > MAX_HEAD_DIM or (hd * size) % _ALIGN:
        raise ValueError(f"head dim {hd} in {q.dtype}: the kernel takes up to "
                         f"{MAX_HEAD_DIM} in whole {_ALIGN}-byte chunks")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{H // KV} query heads a KV head exceed the kernel's {MAX_GROUP}")
    if B > _MAX_GRID or KV > _MAX_GRID:
        raise ValueError(f"{B} rows x {KV} KV heads exceed the kernel's grid ({_MAX_GRID})")
    for name, t, dims in (("q", q, (0, 1)), ("k", k, (0, 1, 2)), ("v", v, (0, 1, 2))):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim is not contiguous (stride {t.stride(-1)})")
        if t.data_ptr() % _ALIGN or any((t.stride(d) * size) % _ALIGN for d in dims
                                        if t.shape[d] > 1):
            raise ValueError(f"{name}'s head rows do not all start {_ALIGN}-byte aligned "
                             f"(strides {t.stride()}); pass a copy (.contiguous())")
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))


def plan_splits(pairs: int, n_valid: int, sms: int) -> int:
    """The split over the slots for ``pairs`` (row, KV head) pairs reading
    ``n_valid`` slots on a card of ``sms`` SMs: as many as keep the blocks
    within one wave, a block an SM, each split at least one tile and the
    tiles spread evenly (so no split is empty).  One block streams at about
    an SM's share of the card's bandwidth, so pairs that already cover the
    SMs split nothing: on an H100 olmo-1b at batch 8 (128 pairs, 1,984
    slots) read its cache in 0.0469 ms in one split and 0.0562 ms in three
    with the combine."""
    return _spread(-(-n_valid // TILE), sms // max(pairs, 1))


def _spread(tiles: int, want: int) -> int:
    """``want`` splits of ``tiles`` tiles clamped to 1 .. ``tiles``, then as
    few as hold the same whole tiles a split, so that none is empty."""
    per = -(-tiles // max(1, min(want, tiles)))
    return -(-tiles // per)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of the card ``device`` names."""
    return _sms(device.index if device.index is not None else torch.cuda.current_device())


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int, *,
                     splits=None) -> torch.Tensor:
    """Attention of q (B, H, hd) over slots ``0 .. n_valid - 1`` of k, v
    (B, T, KV, hd).  Returns (B, H, hd) in q's dtype, contiguous, not
    synchronised.  ``splits``: the split over the slots on the card
    (:func:`plan_splits`'s by default; clamped to 1 .. the tiles and spread
    evenly as it spreads them)."""
    check_operands(q, k, v, n_valid)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, n_valid)
    global launches
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"no decode_attention kernel for device {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("decode_attention has no backward")
    kernel_strides(q, k, v)
    B, H, hd = q.shape
    splits = (plan_splits(B * k.shape[2], n_valid, sm_count(dev)) if splits is None
              else _spread(-(-n_valid // TILE), int(splits)))
    out = torch.empty((B, H, hd), dtype=q.dtype, device=dev)
    part = (torch.empty(splits * B * H * (hd + 2), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    if B == 0:
        return out
    torch.ops.metl_torch.decode_attention(q, k, v, out, part, n_valid, splits)
    launches += 1 + (splits > 1)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            part, n_valid: int, splits: int) -> None:
    """The launch, on operands :func:`decode_attention` has checked.  It
    runs as the operator ``metl_torch::decode_attention``, so that a
    profiler links the kernels to an operator of their own, started where
    the launch is, and not to whatever range the caller has open."""
    B, H, hd = q.shape
    KV = k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    part.data_ptr() if part is not None else None,
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
                    v.stride(0), v.stride(1), v.stride(2),
                    B, KV, H // KV, hd, n_valid, splits, q.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")


if not hasattr(torch.ops.metl_torch, "decode_attention"):  # once a process
    _OPS = torch.library.Library("metl_torch", "FRAGMENT")
    _OPS.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor(a!) out, Tensor? part, "
                "int n_valid, int splits) -> ()")
    _OPS.impl("decode_attention", _launch, "CUDA")
