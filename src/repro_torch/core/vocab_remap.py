"""Model-plane schema evolution: vocabulary remapping as a DMM block.

Counterpart of ``repro.core.vocab_remap``.  When the canonical data model
evolves, the batcher's token space evolves with it (tokens are (CDM slot,
value-bucket) pairs -- etl/batcher.py).  A trained checkpoint can follow the
evolution without retraining from scratch: the old->new vocabulary
correspondence *is* a 1:1 mapping block (new slots that keep their meaning
map to old rows, new slots are fresh, dropped slots are filtered), so
checkpoint surgery is one masked row-gather over the embedding tables --
the paper's Algorithm 6 applied to parameters instead of payloads.

Without noise (``key=None`` or ``fresh_scale=0``) the result equals the
reference's bit for bit.  With a ``key`` the fresh rows are drawn from a
:class:`torch.Generator`, which cannot reproduce ``jax.random.normal``'s
draws: they have the reference's shape, dtype and scale, not its values.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.config import ModelConfig

__all__ = ["vocab_map_from_names", "remap_vocab_params"]


def vocab_map_from_names(old_names: Sequence[str], new_names: Sequence[str]) -> np.ndarray:
    """src[q] = old row feeding new slot q, or -1 for fresh tokens.

    Names play the role of attribute-equivalence roots (paper §5.4.1): a
    token that exists in both vocabularies keeps its embedding."""
    index = {n: i for i, n in enumerate(old_names)}
    return np.asarray([index.get(n, -1) for n in new_names], np.int32)


def remap_vocab_params(
    params: Dict[str, Any],
    src: np.ndarray,
    cfg_old: ModelConfig,
    cfg_new: ModelConfig,
    *,
    fresh_scale: float = 0.0,
    key: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """Rebuild the embedding (and untied head) for the new vocabulary.

    Kept tokens copy their rows (the DMM 1-elements); fresh tokens (src=-1)
    initialise to ``fresh_scale``-scaled standard normal noise drawn from
    ``key`` (0 or no key = zeros).  All other parameters pass through
    untouched -- the surgery is exactly the mapping block.  Raises on a
    ``src`` longer than the new padded vocabulary or naming a row the old
    table lacks.
    """
    V_new = cfg_new.vocab_padded
    if len(src) > V_new:
        raise ValueError("src longer than the new (padded) vocabulary")
    src_pad = np.full((V_new,), -1, np.int32)
    src_pad[: len(src)] = src
    embed = dict(params["embed"])
    tok = embed["tok"]
    if src_pad.max(initial=-1) >= tok.shape[0]:
        raise ValueError(f"src names row {int(src_pad.max())} of a {tok.shape[0]}-row table")
    srcj = torch.from_numpy(src_pad).to(tok.device)
    valid = srcj >= 0
    safe = torch.where(valid, srcj, 0).long()

    new_tok = tok[safe]
    if fresh_scale and key is not None:
        noise = torch.randn((V_new, tok.shape[1]), generator=key, dtype=torch.float32,
                            device=key.device)
        fresh = (noise * fresh_scale).to(tok.device, tok.dtype)
    else:
        fresh = torch.zeros((V_new, tok.shape[1]), dtype=tok.dtype, device=tok.device)
    embed["tok"] = torch.where(valid[:, None], new_tok, fresh)
    if "head" in embed:
        head = embed["head"]  # (D, V)
        new_head = head[:, safe]
        embed["head"] = torch.where(valid[None, :], new_head, torch.zeros_like(new_head))
    out = dict(params)
    out["embed"] = embed
    return out
