"""Assigned architecture configs (+ reduced smoke variants).

``get(arch_id)`` returns the exact assigned config; ``get_smoke(arch_id)``
returns a tiny same-family config for CPU tests.  ``SHAPES`` defines the
four assigned input-shape cells and :func:`cells` enumerates the well-defined
(arch x shape) grid (40 cells; `long_500k` only for sub-quadratic archs is a
*run* restriction -- every cell is enumerated and the skip is recorded).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCHS = [
    "olmo_1b",
    "llama3_405b",
    "phi3_medium_14b",
    "stablelm_1_6b",
    "whisper_tiny",
    "hymba_1_5b",
    "rwkv6_3b",
    "qwen3_moe_30b_a3b",
    "dbrx_132b",
    "internvl2_1b",
]

# canonical ids use dashes; module names use underscores
def _mod(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def get(arch_id: str) -> ModelConfig:
    m = importlib.import_module(f"repro_torch.configs.{_mod(arch_id)}")
    return m.CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    m = importlib.import_module(f"repro_torch.configs.{_mod(arch_id)}")
    return m.SMOKE


def runnable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Is (arch, shape) a runnable cell?  (Skips recorded in DESIGN.md.)"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is quadratic-history"
    return True, ""


def cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
