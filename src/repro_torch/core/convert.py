"""Carry the reference's state into the port.

The mapping system has no weights: what carries across is the registry and
the DPM.  :func:`coordinator_from_snapshot` takes the plain dict that
``repro.etl.transport.encode_snapshot`` produces -- ``{"v", "registry",
"dpm", "frozen", "log_offset"}``, with the DPM as ``"o,v,r,w" -> [[q, p],
...]`` -- and returns the port's :class:`~repro_torch.core.state.
StateCoordinator` holding the same state.  The dict is plain data (JSON
types), so it can cross a process or a file unchanged.

The model zoo does have weights: :func:`params_from_jax` takes the
reference's parameter pytree as nested dicts of numpy arrays (what
``jax.tree_util.tree_map(np.asarray, params)`` makes of it) and returns the
port's parameters, dtype kept, on a given device.  :func:`params_to_jax`
is its inverse, for parameters, gradients and optimizer moments alike:
numpy has no bfloat16 of its own, so a bfloat16 leaf crosses as its raw
16-bit pattern (a ``uint16`` view), and :func:`params_from_jax` reads a
``uint16`` leaf back as bfloat16 bits (no parameter of the zoo is an
unsigned integer).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..etl.transport import WIRE_VERSION, decode_snapshot
from .dmm_torch import DeviceLike, resolve_device
from .state import StateCoordinator

__all__ = ["WIRE_VERSION", "coordinator_from_snapshot", "numpy_to_tensor", "params_from_jax",
           "params_to_jax", "stack_layers", "tensor_to_numpy"]


def coordinator_from_snapshot(d: Dict[str, Any]) -> StateCoordinator:
    """The port's coordinator for a snapshot dict (see module docstring),
    decoded by :func:`repro_torch.etl.transport.decode_snapshot`.

    Raises ValueError on any wire version other than :data:`WIRE_VERSION`.
    The restored coordinator keeps the snapshot's frozen flag and starts its
    control log at the snapshot's ``log_offset``.
    """
    if d.get("v") != WIRE_VERSION:
        raise ValueError(
            f"snapshot wire version {d.get('v')!r}, this reader speaks {WIRE_VERSION}"
        )
    return decode_snapshot(d)


# the reference stacks these layer lists along a leading axis (for lax.scan);
# the port keeps one dict per layer
_STACKED = ("layers", "enc_layers")


# numpy has no bfloat16 or float8 of its own: such a tensor crosses as its
# same-width unsigned view ((signed torch view, numpy view) of its bits)
_BITS = {torch.bfloat16: (torch.int16, np.uint16), torch.float8_e4m3fn: (torch.int8, np.uint8),
         torch.float8_e5m2: (torch.int8, np.uint8)}


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a C-ordered numpy array on the host, its bits kept: a
    bfloat16 or float8 tensor as its unsigned-integer view."""
    t = t.detach().cpu().contiguous()
    if t.dtype in _BITS:
        ints, uints = _BITS[t.dtype]
        return t.view(ints).numpy().view(uints)
    return t.numpy()


def numpy_to_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host tensor of ``dtype`` owning a copy of ``a``'s bits: ``a`` is
    an array of that dtype, or the unsigned view :func:`tensor_to_numpy`
    writes for bfloat16 and float8."""
    t = torch.from_numpy(np.array(a, order="C"))  # a copy; keeps a 0-d array 0-d
    if dtype in _BITS:
        return t.view(_BITS[dtype][0]).view(dtype)
    return t


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype.name in ("bfloat16", "uint16"):  # bfloat16 (ml_dtypes) or its bits
        return numpy_to_tensor(a.view(np.uint16), torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(np.asarray(tree), device)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _depth(tree: Any) -> int:
    if isinstance(tree, dict):
        for v in tree.values():
            n = _depth(v)
            if n >= 0:
                return n
        return -1
    return int(np.asarray(tree).shape[0])


def params_from_jax(tree: Dict[str, Any], *, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The port's parameters for the reference's parameter pytree ``tree``
    (nested dicts of numpy arrays), on ``device`` (the card by default;
    raises when there is none).  Values and dtypes are kept bit for bit
    (bfloat16 included); the stacked ``layers`` / ``enc_layers`` become one
    dict per layer."""
    dev = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key in _STACKED:
            out[key] = [_convert(_unstack(sub, i), dev) for i in range(_depth(sub))]
        else:
            out[key] = _convert(sub, dev)
    return out


def stack_layers(tree: Any) -> Any:
    """The reference's layout of a port tree, tensors kept: every
    ``layers`` / ``enc_layers`` list of per-layer dicts (at any depth, so
    an optimizer state's ``m`` and ``v`` too) stacked leaf by leaf along a
    new leading axis."""
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            if key in _STACKED and isinstance(sub, list):
                out[key] = _stack(sub) if sub else {}
            else:
                out[key] = stack_layers(sub)
        return out
    return tree


def _stack(layers: list) -> Any:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack([t.detach() for t in layers])


def params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a port tree (parameters,
    gradients or an optimizer moment tree) as the reference lays it out,
    nested dicts of numpy arrays on the host with ``layers`` /
    ``enc_layers`` stacked on a leading axis and dtypes kept; bfloat16
    leaves as their raw ``uint16`` views.  ``params_from_jax(
    params_to_jax(p))`` gives back ``p`` bit for bit."""

    def conv(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_to_numpy(t)

    return conv(stack_layers(tree))
