"""The numbers that decide ``correct``, each a reading held against the
limit the cell's limits file gives it (correct iff reading <= limit)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def mismatches(program: np.ndarray, ref: np.ndarray) -> int:
    """Entries that differ between two arrays (exact); every entry of the
    reference where the shapes differ."""
    if program.shape != ref.shape:
        return int(ref.size)
    return int(np.count_nonzero(program != ref))


def gaps_summary(gaps: torch.Tensor) -> Dict[str, float]:
    g = gaps.double().flatten().cpu()
    return {"max": float(g.max()), "p99": float(torch.quantile(g, 0.99)),
            "mean": float(g.mean()), "zero_share": float((g == 0).double().mean())}
