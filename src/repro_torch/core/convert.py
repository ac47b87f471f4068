"""Carry a reference coordinator's state into the port.

This system has no weights: what carries across is the registry and the
DPM.  :func:`coordinator_from_snapshot` takes the plain dict that
``repro.etl.transport.encode_snapshot`` produces -- ``{"v", "registry",
"dpm", "frozen", "log_offset"}``, with the DPM as ``"o,v,r,w" -> [[q, p],
...]`` -- and returns the port's :class:`~repro_torch.core.state.
StateCoordinator` holding the same state.  The dict is plain data (JSON
types), so it can cross a process or a file unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

from .dmm import DPM
from .registry import Registry
from .state import StateCoordinator

__all__ = ["WIRE_VERSION", "coordinator_from_snapshot"]

WIRE_VERSION = 1  # the snapshot wire version this module reads


def _decode_dpm(d: Dict[str, Any]) -> DPM:
    return {
        tuple(int(x) for x in key.split(",")): frozenset(
            (int(q), int(p)) for q, p in elements
        )
        for key, elements in d.items()
    }


def coordinator_from_snapshot(d: Dict[str, Any]) -> StateCoordinator:
    """The port's coordinator for a snapshot dict (see module docstring).

    Raises ValueError on any wire version other than :data:`WIRE_VERSION`.
    The restored coordinator keeps the snapshot's frozen flag and starts its
    control log at the snapshot's ``log_offset``.
    """
    if d.get("v") != WIRE_VERSION:
        raise ValueError(
            f"snapshot wire version {d.get('v')!r}, this reader speaks {WIRE_VERSION}"
        )
    return StateCoordinator(
        Registry.from_dict(d["registry"]),
        _decode_dpm(d["dpm"]),
        frozen=bool(d["frozen"]),
        log_base=int(d["log_offset"]),
    )
