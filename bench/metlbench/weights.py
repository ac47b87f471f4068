"""The cell's weights, drawn from the seed on the device in the type they
are served in: one normal draw over one flat buffer a dtype, then each
leaf scaled to std 1/sqrt(fan-in).  Norm scales are ones and norm biases
zeros, as the port initialises them.  The tree has the port's layout (taken
from ``init_params`` on the ``meta`` device, which draws nothing), so the
program and the plain reference read the same tensors."""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch


def leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of each tensor of a parameter tree, in its order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in leaves(t, path + (i,))]
    return [(path, tree)]


def _put(tree: Any, path: Tuple, value: torch.Tensor) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _std(path: Tuple, shape: torch.Size) -> float:
    """1/sqrt(fan-in): the rows of a product's (D_in, D_out) weight, the
    middle axis of an expert stack (E, D_in, D_out), the width of the token
    table (V, D)."""
    if path[-1] == "tok":
        return 1.0 / math.sqrt(shape[1])
    return 1.0 / math.sqrt(shape[-2])


def make(cfg, seed: int, device: torch.device) -> Dict[str, Any]:
    """The parameter tree of ``cfg`` from ``seed`` on ``device``."""
    from repro_torch.models import model as M

    tree = M.init_params(cfg, device="meta")
    named = leaves(tree)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    by_dtype: Dict[torch.dtype, List] = {}
    for path, t in named:
        if path[-1] in ("scale", "bias"):
            fill = 1.0 if path[-1] == "scale" else 0.0
            _put(tree, path, torch.full(t.shape, fill, dtype=t.dtype, device=device))
        else:
            by_dtype.setdefault(t.dtype, []).append((path, t))
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.empty(sum(t.numel() for _, t in group), dtype=dtype, device=device)
        flat.normal_(generator=gen)
        at = 0
        for path, t in group:
            view = flat[at:at + t.numel()].view(t.shape)
            view.mul_(_std(path, t.shape))
            _put(tree, path, view)
            at += t.numel()
    return tree
