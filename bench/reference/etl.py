"""Plain reference of the METL layer the benchmark's cells feed through:
CDC events mapped to canonical rows by the ground-truth mapping matrix,
then tokenized, in plain Python and NumPy.  It imports nothing of the
program; it reads the scenario's mapping as plain arrays and each event
chunk as its columns (both made by the benchmark from the seed and handed
to both sides).

Semantics (paper SS3.4-5.5, as the METL app states them): an event whose
key is among the last ``dedup_window`` distinct keys is a duplicate and
dropped; an event of another state than the app's is not mapped; an
event of extraction schema version (o, v) yields, for each business entity
version (r, w) that the matrix maps (o, v) to, one row over (r, w)'s
attributes in registry order: the value of each present attribute that
maps there, and a mask.  A row with no value is not sent.  Within a chunk
the rows come column by column ((o, v) in the order of their first mapped
event), and within a column in arrival order.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Tuple

import numpy as np

BOS = 1
VALUE_BUCKETS = 64


Route = Tuple[Tuple[int, int], int, Dict[int, int]]  # (r, w), width, {uid: position}


class Mapping:
    """The ground-truth matrix as lookups: for each extraction column (o, v)
    its routes, each a business entity version (r, w) with its width and
    {extraction uid: output position}; and the state the app serves."""

    def __init__(self, entries: Dict[Tuple[int, int], List[Route]], state: int):
        self.entries = entries
        self.state = state


def rows(mapping: Mapping, chunk: Dict[str, np.ndarray], seen: "collections.OrderedDict",
         dedup_window: int) -> List[Tuple[Tuple[int, int], np.ndarray, np.ndarray, int]]:
    """Canonical rows ((r, w), values, mask, key) of one chunk; ``seen`` is
    the dedup window carried from chunk to chunk."""
    by_col: Dict[Tuple[int, int], List[int]] = {}
    keys = chunk["keys"].tolist()
    for e, key in enumerate(keys):
        if key in seen:
            continue
        seen[key] = True
        while len(seen) > dedup_window:
            seen.popitem(last=False)
        if chunk["bad"][e] or int(chunk["states"][e]) != mapping.state:
            continue
        col = (int(chunk["schema_ids"][e]), int(chunk["versions"][e]))
        by_col.setdefault(col, []).append(e)
    out = []
    off = chunk["event_offsets"]
    for col, events in by_col.items():
        for route, width, pos in mapping.entries.get(col, []):
            for e in events:
                vals = np.zeros(width, np.float32)
                mask = np.zeros(width, bool)
                for uid, val in zip(chunk["uids"][off[e]:off[e + 1]].tolist(),
                                    chunk["vals"][off[e]:off[e + 1]]):
                    q = pos.get(uid)
                    if q is not None:
                        vals[q], mask[q] = val, True
                if mask.any():
                    out.append((route, vals, mask, keys[e]))
    return out


def tokens(row, vocab: int) -> List[int]:
    """A row as tokens: BOS, then per present slot q of value x, 2 + (q * 64
    + int(x) mod 64) mod (vocab - 2)."""
    _, vals, mask, _ = row
    q = np.nonzero(mask)[0]
    if q.size == 0:
        return [BOS]
    b = vals[q].astype(np.float64).astype(np.int64) % VALUE_BUCKETS
    return [BOS] + (2 + (q * VALUE_BUCKETS + b) % (vocab - 2)).tolist()


def token_stream(mapping: Mapping, chunks: Iterable[Dict[str, np.ndarray]], vocab: int,
                 need: int, dedup_window: int, per_row=None) -> List[int]:
    """The first ``need`` tokens of the rows of ``chunks``, in order;
    ``per_row`` cuts each row's tokens (the prompts' rule) when given."""
    seen: collections.OrderedDict = collections.OrderedDict()
    out: List[int] = []
    for chunk in chunks:
        for row in rows(mapping, chunk, seen, dedup_window):
            t = tokens(row, vocab)
            out.extend(t if per_row is None else t[:per_row])
        if len(out) >= need:
            return out[:need]
    raise ValueError(f"the chunks gave {len(out)} tokens, {need} needed")


def batches(stream: List[int], batch: int, seq: int, n: int) -> List[Dict[str, np.ndarray]]:
    """``n`` (batch, seq) language-model batches cut from the token stream:
    each takes the next batch * (seq + 1) tokens; tokens are the first seq
    of each row, labels the last seq, every weight 1."""
    per = batch * (seq + 1)
    out = []
    for i in range(n):
        flat = np.asarray(stream[i * per:(i + 1) * per], np.int32).reshape(batch, seq + 1)
        out.append({"tokens": flat[:, :-1], "labels": flat[:, 1:],
                    "loss_weight": np.ones((batch, seq), np.float32)})
    return out
