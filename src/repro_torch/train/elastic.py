"""Elastic scaling, straggler mitigation and failure handling.

Counterpart of ``repro.train.elastic``.  The fault-tolerance contract:

  1. **Checkpoint/restart** -- step-granular atomic checkpoints
     (:mod:`repro_torch.train.checkpoint`); a restart resumes from the
     latest complete step on whatever mesh is available.
  2. **Elastic resharding** -- :func:`reshard_checkpoint` loads a checkpoint
     saved on mesh A and places it onto mesh B (another data/model split,
     fewer or more ranks); the array files hold whole arrays keyed by leaf
     path, so resharding is pure placement.
  3. **Deterministic data reassignment** -- batches are pure functions of
     (state i, step, shard): :func:`shard_assignment` recomputes who loads
     what after membership changes, and any host can *recompute* a
     straggler's shard instead of waiting for it.
  4. **Straggler watchdog** -- :class:`StragglerWatchdog` times per-host
     step contributions and reassigns a slice when a host exceeds the
     median-based deadline (host-count agnostic).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.config import ModelConfig
from .checkpoint import latest_step, restore

__all__ = [
    "reshard_checkpoint",
    "shard_assignment",
    "StragglerWatchdog",
]


def reshard_checkpoint(
    base: str,
    cfg: ModelConfig,
    make_like: Callable[[Any], Tuple[Any, Any]],
    new_mesh: Any,
    step: Optional[int] = None,
) -> Tuple[Any, Any, Dict]:
    """Load the latest (or given) checkpoint onto a *different* mesh.

    ``make_like(new_mesh)`` builds (params, opt_state) trees placed for the
    new mesh (e.g. ``init_all(cfg, tc, new_mesh, device=...)[:2]``);
    restore then places every leaf as its ``like`` leaf.  Every rank of
    ``new_mesh`` calls it."""
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {base}")
    like = make_like(new_mesh)
    return restore(base, step, like)


def shard_assignment(step: int, hosts: Sequence[str], n_shards: int) -> Dict[str, List[int]]:
    """Deterministic shard->host assignment for a step.

    Membership-change safe: the assignment depends only on (step, sorted
    hosts), so all survivors compute the same mapping without coordination.
    """
    hosts = sorted(hosts)
    out: Dict[str, List[int]] = {h: [] for h in hosts}
    for s in range(n_shards):
        h = hosts[(s + step) % len(hosts)]  # rotate to spread hot shards
        out[h].append(s)
    return out


@dataclasses.dataclass
class StragglerWatchdog:
    """Deadline-based straggler detection with work-stealing reassignment.

    Hosts report per-step durations; the deadline is ``factor`` x the
    median of every reported duration (each host's last ``window``).
    ``stragglers`` returns the hosts past it; the caller recomputes their
    shards locally (legal because batches are deterministic in (state,
    step, shard)).
    """

    factor: float = 3.0
    window: int = 32

    def __post_init__(self):
        self._durations: Dict[str, List[float]] = {}

    def report(self, host: str, duration: float) -> None:
        self._durations.setdefault(host, []).append(duration)
        self._durations[host] = self._durations[host][-self.window :]

    def deadline(self) -> Optional[float]:
        all_d = [d for ds in self._durations.values() for d in ds]
        if len(all_d) < 4:
            return None
        return float(np.median(all_d) * self.factor)

    def stragglers(self, inflight: Dict[str, float], now: Optional[float] = None) -> List[str]:
        """inflight: host -> step start time.  Returns hosts past deadline."""
        dl = self.deadline()
        if dl is None:
            return []
        now = time.time() if now is None else now
        return [h for h, t0 in inflight.items() if (now - t0) > dl]

    def reassign(
        self, step: int, straggler: str, hosts: Sequence[str], n_shards: int
    ) -> Dict[str, List[int]]:
        """New assignment with the straggler's shards redistributed."""
        healthy = [h for h in hosts if h != straggler]
        return shard_assignment(step, healthy, n_shards)
