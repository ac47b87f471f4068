"""Step marks on the device's timeline: a CUDA event recorded after each
step (no sync in the loop), read once the window has closed.  On the CPU,
where every operation has ended when it returns, the host clock."""

from __future__ import annotations

import time
from typing import List

import torch


class Marks:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: List = []
        self._start = None

    def start(self) -> None:
        """The window's origin (the device is idle: the caller synchronised)."""
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def mark(self) -> int:
        """Record the end of the work enqueued so far; returns its index."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append(ev)
        else:
            self._marks.append(time.perf_counter())
        return len(self._marks) - 1

    def seconds(self) -> List[float]:
        """Each mark's time after the start, in seconds (synchronises)."""
        if self.cuda:
            torch.cuda.synchronize()
            return [self._start.elapsed_time(ev) * 1e-3 for ev in self._marks]
        return [t - self._start for t in self._marks]
