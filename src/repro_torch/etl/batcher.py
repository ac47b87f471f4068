"""(Port copy of ``repro.etl.batcher``: the same code, kept here so that
``repro_torch`` imports nothing of the reference package.)

Canonical-row -> token-batch packing (the loader of the trainer).

The CDM of a trainer is the canonical batch schema {tokens, labels,
loss_weight}: whatever the upstream microservices emit, the model consumes
exactly this.  The batcher tokenizes canonical rows (business-entity slot,
quantized value) and packs them into fixed (batch, seq) tensors.

Determinism: batches are pure functions of (state i, step, shard), so any
host can recompute any shard -- a straggling or replaced host never blocks
the step (DESIGN SS4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..models.config import ModelConfig
from .metl import CanonicalRow

__all__ = ["CanonicalBatcher", "make_token_batch", "tokenize_row"]

BOS = 1
VALUE_BUCKETS = 64


def tokenize_row(row: CanonicalRow, vocab: int) -> List[int]:
    """(slot, value) pairs -> stable token ids in [2, vocab).

    Vectorised: one nonzero + one modular-arithmetic pass per row, so the
    batcher keeps up with the fused mapping engine's chunk throughput.
    """
    (_, _), vals, mask, _ = row
    slots = np.nonzero(np.asarray(mask) != 0)[0]
    if slots.size == 0:
        return [BOS]
    buckets = np.asarray(vals, np.float64)[slots].astype(np.int64) % VALUE_BUCKETS
    return [BOS] + (2 + (slots * VALUE_BUCKETS + buckets) % (vocab - 2)).tolist()


@dataclasses.dataclass
class CanonicalBatcher:
    """Streams canonical rows into packed LM batches."""

    vocab: int
    seq_len: int
    batch_size: int

    def __post_init__(self):
        self._buf: List[int] = []

    def add_rows(self, rows: List[CanonicalRow]) -> None:
        for row in rows:
            self._buf.extend(tokenize_row(row, self.vocab))

    def ready(self) -> bool:
        return len(self._buf) >= self.batch_size * (self.seq_len + 1)

    def next_batch(self) -> Dict[str, np.ndarray]:
        need = self.batch_size * (self.seq_len + 1)
        if len(self._buf) < need:
            raise ValueError("not enough buffered tokens")
        flat = np.asarray(self._buf[:need], np.int32).reshape(
            self.batch_size, self.seq_len + 1
        )
        self._buf = self._buf[need:]
        return {
            "tokens": flat[:, :-1],
            "labels": flat[:, 1:],
            "loss_weight": np.ones((self.batch_size, self.seq_len), np.float32),
        }


def make_token_batch(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    *,
    step: int = 0,
    shard: int = 0,
    state: int = 0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Deterministic synthetic batch (the ETL-free fast path for examples,
    smoke tests and benchmarks).  Same (state, step, shard, seed) -> same
    batch, which is all the elasticity machinery needs."""
    rng = np.random.default_rng((seed, state, step, shard))
    flat = rng.integers(2, cfg.vocab, size=(batch, seq + 1), dtype=np.int32)
    out = {
        "tokens": flat[:, :-1],
        "labels": flat[:, 1:],
        "loss_weight": np.ones((batch, seq), np.float32),
    }
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(batch, cfg.enc_seq, cfg.d_model)).astype(
            np.float32
        )
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(batch, cfg.frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    return out
