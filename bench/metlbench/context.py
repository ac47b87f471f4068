"""A job's context built in set-up: the K and V of its first positions
written into the program's decode state by the program's own full-sequence
``forward`` (the prefill a deployment runs), a block of rows at a time.

Each layer's keys and values are taken where the forward computes them:
``attention_train`` (the name ``models.model`` calls it by) is wrapped for
the call, and the wrapper works out the layer's K and V of its input with
the program's projection and rotary embedding and writes them into that
layer's cache at positions 0 .. S - 1, as a decode step writes its one
position.  The decode state then stands where stepping the same tokens
would leave it (``bench/test_bench_runs.py`` holds the two together).  Not
for sparse experts: their forward drops tokens beyond an expert's capacity,
which decode never does."""

from __future__ import annotations

from typing import Any, Dict

import torch


def fill(params: Dict[str, Any], cfg, state: Dict[str, Any], tokens: torch.Tensor,
         block_rows: int) -> Dict[str, Any]:
    """The decode ``state`` with the context ``tokens`` (R, S) written at
    positions 0 .. S - 1 of every row, its position S."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    if cfg.is_moe:
        raise ValueError("a sparse-expert forward drops tokens beyond an expert's capacity, "
                         "which decode never does: step the context instead")
    R, S = tokens.shape
    at = {"layer": 0, "rows": slice(0, 0)}
    orig = M.attention_train

    def capture(p, x, positions, cfg_, **kwargs):
        k, v = A._kv_proj(p, x, cfg_)
        if cfg_.pos == "rope":
            k = A.rope(k, positions, cfg_.rope_theta)
        state["k"][at["layer"]][at["rows"], :S] = k
        state["v"][at["layer"]][at["rows"], :S] = v
        at["layer"] += 1
        return orig(p, x, positions, cfg_, **kwargs)

    M.attention_train = capture
    try:
        with torch.no_grad():
            for r0 in range(0, R, block_rows):
                at["layer"], at["rows"] = 0, slice(r0, min(r0 + block_rows, R))
                M.forward(params, cfg, {"tokens": tokens[at["rows"]]})
                if at["layer"] != cfg.n_layers:
                    raise RuntimeError(f"the forward wrote {at['layer']} of {cfg.n_layers} "
                                       "layers' caches")
    finally:
        M.attention_train = orig
    return {**state, "pos": S}
