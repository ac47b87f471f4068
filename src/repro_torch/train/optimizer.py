"""AdamW over the port's parameter trees, and int8 quantization.

Counterpart of ``repro.train.optimizer``: the same config, state layout
(``{"step", "m", "v"}``, plus ``"ef"`` under ``compress_grads``), schedule,
clipping and update, on plain tensors as ``torch.no_grad()`` updates (not a
``torch.optim.Optimizer``).  The update rounds where the reference rounds:
the step counter is an int32 tensor; ``b1 ** step``, ``b2 ** step``, the
warm-up factor, the learning rate and the clip scale are float32 tensors
(never Python float64); the update runs in float32; ``m`` and ``v`` are
carried in ``moment_dtype`` and the parameters are cast back to their own
dtype.  Nothing here synchronises with the device: the metrics are
tensors.

``compress_grads_int8``, the reference's int8 all-reduce with error
feedback, needs the data-parallel collectives and is not here (ROADMAP
item 15.3); ``adamw_init`` still makes the ``"ef"`` buffers, as the
reference's does, and ``adamw_update`` leaves them as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..core.tree import tree_leaves, tree_map

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "quantize_int8",
    "dequantize_int8",
]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # bfloat16 for >=100B params
    warmup_steps: int = 100
    # int8 DP-all-reduce compression with error feedback
    compress_grads: bool = False


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``moment_dtype`` beside each parameter, on its
    device, and an int32 step counter on the parameters' device."""
    mdt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }
    if cfg.compress_grads:
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device),
                               params)
    return state


def _const(value: float, device: torch.device) -> torch.Tensor:
    """``value`` rounded to a float32 scalar on ``device``, filled there (a
    host-to-device copy would wait for the stream)."""
    return torch.full((), value, dtype=f32, device=device)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``: float32 ``lr * min(step / warmup, 1)``."""
    warm = torch.clamp(step.to(f32) / max(cfg.warmup_steps, 1), max=1.0)
    return _const(cfg.lr, step.device) * warm


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, a float32 scalar."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(f32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total) if total is not None else torch.zeros((), dtype=f32)


@torch.no_grad()
def adamw_update(grads: Any, state: Dict[str, Any], params: Any, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    ``metrics = {"grad_norm", "lr"}``, float32 scalars on the device.  The
    inputs are not modified: every leaf of the result is a new tensor, as in
    the reference."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    dev = step.device
    scale = torch.clamp(_const(cfg.grad_clip, dev) / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = _const(cfg.b1, dev), _const(cfg.b2, dev)
    one_b1, one_b2 = _const(1 - cfg.b1, dev), _const(1 - cfg.b2, dev)
    bc1 = 1.0 - torch.pow(b1, step.to(f32))
    bc2 = 1.0 - torch.pow(b2, step.to(f32))
    eps, wd = _const(cfg.eps, dev), _const(cfg.weight_decay, dev)

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        mf = m.to(f32) * b1 + g * one_b1
        vf = v.to(f32) * b2 + torch.square(g) * one_b2
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(f32)
        p2 = p.to(f32) - lr * delta
        return p2.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731 (the tuples are leaves)
    new_state = dict(state, step=step, m=pick(1), v=pick(2))
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# int8 quantization (the wire format of the compressed all-reduce)
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization.  Returns (q int8, scale
    float32 scalar): ``scale = max(max|x| / 127, 1e-30)``, ``q =
    clip(round_half_even(x / scale), -127, 127)``."""
    xf = x.to(f32)
    scale = torch.clamp(torch.amax(torch.abs(xf)) / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale
