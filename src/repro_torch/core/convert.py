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
port's parameters, dtype kept, on a given device.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..etl.transport import WIRE_VERSION, decode_snapshot
from .dmm_torch import DeviceLike, resolve_device
from .state import StateCoordinator

__all__ = ["WIRE_VERSION", "coordinator_from_snapshot", "params_from_jax"]


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


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: the port owns its parameters
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
