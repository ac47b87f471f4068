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

Under the model mesh the parameters, gradients and moments are DTensors:
the update runs on each rank's shards, and :func:`global_norm` sums every
distinct shard once, over the mesh.

:func:`compress_grads_int8` is the reference's int8 all-reduce with error
feedback, for the explicit data-parallel step
(:func:`repro_torch.train.loop.make_dp_train_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..core.tree import tree_leaves, tree_map, tree_unflatten
from ..sharding import comm
from ..sharding.specs import is_dtensor

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "compress_grads_int8",
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
    device (DTensors placed as their parameters), and an int32 step counter
    on the parameters' device."""
    mdt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    # zeros_like: a DTensor parameter gets a DTensor moment, placed as it is
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }
    if cfg.compress_grads:
        state["ef"] = tree_map(lambda p: torch.zeros_like(p, dtype=f32), params)
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
    """sqrt of the float32 sum of squares of every leaf, a float32 scalar.
    DTensor leaves: each leaf's sum over its distinct shards, from one
    all-reduce over the mesh; the leaves summed in order after it."""
    leaves = tree_leaves(tree)
    if leaves and is_dtensor(leaves[0]):
        return torch.sqrt(_sum_in_order(_shard_squares(leaves)))
    total = None
    for leaf in leaves:
        sq = torch.sum(torch.square(leaf.to(f32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total) if total is not None else torch.zeros((), dtype=f32)


def _sum_in_order(parts: torch.Tensor) -> torch.Tensor:
    total = parts[0]
    for sq in parts[1:]:
        total = total + sq
    return total


def _shard_squares(leaves) -> torch.Tensor:
    """(n_leaves,) float32: each DTensor leaf's sum of squares.  A rank
    adds its shard only when it is the first holder of that shard (index
    0 along every mesh axis that replicates the leaf); the vector is then
    summed over each mesh axis in turn."""
    from torch.distributed.tensor import Replicate

    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    parts = []
    for t in leaves:
        sq = torch.sum(torch.square(t.to_local().to(f32)))
        dup = any(isinstance(pl, Replicate) and c != 0 for pl, c in zip(t.placements, coord))
        parts.append(torch.zeros_like(sq) if dup else sq)
    vec = torch.stack(parts)
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            comm.all_reduce(vec, mesh.get_group(i))
    return vec


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (a shard) as a DTensor placed as ``ref`` when ``ref`` is one."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


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

    def upd(p_, g_, m_, v_):  # on this rank's shards of DTensor leaves
        p, g, m, v = _local(p_), _local(g_), _local(m_), _local(v_)
        g = g.to(f32) * scale
        mf = m.to(f32) * b1 + g * one_b1
        vf = v.to(f32) * b2 + torch.square(g) * one_b2
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(f32)
        p2 = p.to(f32) - lr * delta
        return _like(p2.to(p.dtype), p_), _like(mf.to(m.dtype), m_), _like(vf.to(v.dtype), v_)

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


def compress_grads_int8(grads: Any, ef: Any, group=None) -> Tuple[Any, Any]:
    """The data-parallel mean of ``grads`` over ``group`` in int8 wire
    format with error feedback; returns (mean gradients, new ``ef``).

    Every rank calls it with its local gradients and its residuals ``ef``
    (float32, the gradients' structure).  Per leaf, in the reference's
    order of float32 operations: ``total = g + ef``; the scale ``max|total|
    / 127`` clamped at 1e-30; its maximum over the group; ``q =
    clip(round(total / gscale), -127, 127)`` as int8 (round half to even,
    as ``jnp.round``); the new residual ``total - q * gscale``, rounded
    once (XLA contracts it into a fused multiply-add); the sum of
    ``q`` over the group; then ``sum * gscale / n`` in the gradient's
    dtype.  The sum runs on the payload widened to int32, as the
    reference's ``psum`` does.  Two collectives in all: one maximum over
    the vector of per-leaf scales, one int32 sum over the concatenated
    payloads (both exact, so their order does not matter)."""
    g_leaves, e_leaves = tree_leaves(grads), tree_leaves(ef)
    if not g_leaves:
        return grads, ef
    n = dist.get_world_size(group)
    totals = [g.to(f32) + e for g, e in zip(g_leaves, e_leaves)]
    gscale = torch.stack([torch.clamp(torch.amax(torch.abs(t)) / 127.0, min=1e-30)
                          for t in totals])
    comm.all_reduce(gscale, group, op=dist.ReduceOp.MAX)
    qs = [torch.clamp(torch.round(t / gscale[i]), -127, 127).to(torch.int8)
          for i, t in enumerate(totals)]
    # the residual rounded once, as XLA's fused multiply-add computes the
    # reference's ``total - q * gscale``: q * gscale is exact in float64 and
    # so is the difference (q * gscale is within half a step of total)
    errs = [(t.double() - q.double() * gscale[i].double()).to(f32)
            for i, (t, q) in enumerate(zip(totals, qs))]
    summed = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    comm.all_reduce(summed, group)
    means, at = [], 0
    for i, g in enumerate(g_leaves):
        part = summed[at:at + g.numel()].view(g.shape)
        at += g.numel()
        means.append((part.to(f32) * gscale[i] / n).to(g.dtype))
    return tree_unflatten(grads, means), tree_unflatten(ef, errs)
