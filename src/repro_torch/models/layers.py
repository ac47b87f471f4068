"""Shared building blocks for the architecture zoo.

Counterpart of ``repro.models.layers``.  Everything is functional: params
are plain dicts of tensors in the reference's layout (``x @ W`` with ``W``
of shape (D_in, D_out)), layers are functions.  Randomness comes from an
explicit :class:`torch.Generator` on the device the parameters go to.
Model-level stacking lives in :mod:`repro_torch.models.model`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..sharding import comm
from .config import ModelConfig

__all__ = [
    "trunc_normal",
    "norm_params",
    "apply_norm",
    "rope",
    "mlp_params",
    "apply_mlp",
    "embed_params",
    "lm_logits",
    "cross_entropy",
    "cross_entropy_sums",
    "split_group",
    "vocab_start",
]


def trunc_normal(gen: torch.Generator, shape: Sequence[int], scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """He-style truncated normal init (std = scale / sqrt(fan_in)), cut at
    +-2 standard deviations as the reference's ``truncated_normal(-2, 2)``;
    drawn in float32 on ``gen``'s device, then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale / math.sqrt(max(fan_in, 1))
    x = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if x.device.type != "meta":  # meta: shapes alone, nothing drawn (the dry run)
        torch.nn.init.trunc_normal_(x, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                    generator=gen)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_params(cfg: ModelConfig, device: torch.device,
                with_bias: Optional[bool] = None) -> Dict[str, torch.Tensor]:
    """Parameters for one norm site (possibly empty -- olmo's non-parametric LN)."""
    if cfg.norm == "nonparametric_ln":
        return {}
    if with_bias is None:
        with_bias = cfg.norm == "layernorm"
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((cfg.d_model,), dtype=cfg.pdtype, device=device)
    return p


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm, layernorm or non-parametric layernorm in float32, cast back
    to ``x.dtype``."""
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * p["scale"].to(torch.float32)).to(x.dtype)
    # layernorm (parametric or olmo's non-parametric variant)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    if p:
        xf = xf * p["scale"].to(torch.float32)
        if "bias" in p:
            xf = xf + p["bias"].to(torch.float32)
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x: (..., S, H, hd), positions:
    broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )  # (half,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    D, F_ = cfg.d_model, cfg.d_ff
    p = {
        "w_in": trunc_normal(gen, (D, F_), 1.0, cfg.pdtype),
        "w_out": trunc_normal(gen, (F_, D), 1.0, cfg.pdtype),
    }
    if cfg.activation == "swiglu":
        p["w_gate"] = trunc_normal(gen, (D, F_), 1.0, cfg.pdtype)
    return p


def split_group(sh, cfg: ModelConfig, part: str):
    """The model group when the sharding policy ``sh`` (or None) splits
    ``part`` of ``cfg`` over ``model`` (:meth:`~repro_torch.sharding.specs.
    ShardingPolicy.split_group`), else None."""
    return None if sh is None else sh.split_group(cfg, part)


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              sh=None) -> torch.Tensor:
    """SwiGLU or GELU (tanh approximation, as ``jax.nn.gelu``'s default);
    the activation in float32, the products in the compute dtype.  ``sh``:
    a sharding policy; where it splits the hidden over ``model``, ``p``
    holds this rank's column slices of ``w_in``/``w_gate`` and row slice
    of ``w_out`` (:meth:`~repro_torch.sharding.specs.ShardingPolicy.
    gather_layer`), the activation runs on the F/M hidden and the partial
    outputs are summed over the group."""
    group = split_group(sh, cfg, "ff")
    if group is not None:
        x = comm.copy_to_model(x, group)
    h = torch.matmul(x, p["w_in"].to(cfg.cdtype))
    if cfg.activation == "swiglu":
        g = torch.matmul(x, p["w_gate"].to(cfg.cdtype))
        h = F.silu(g.to(torch.float32)).to(cfg.cdtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(cfg.cdtype)
    if sh is not None:
        h = sh.act_ff(h)
    out = torch.matmul(h, p["w_out"].to(cfg.cdtype))
    return out if group is None else comm.reduce_from_model(out, group)


# ---------------------------------------------------------------------------
# Embeddings & loss
# ---------------------------------------------------------------------------


def embed_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    V, D = cfg.vocab_padded, cfg.d_model
    p = {"tok": trunc_normal(gen, (V, D), math.sqrt(D), cfg.pdtype)}
    if not cfg.tie_embeddings:
        p["head"] = trunc_normal(gen, (D, V), 1.0, cfg.pdtype)
    if cfg.pos == "learned":
        p["pos"] = trunc_normal(gen, (cfg.max_seq_emb() or cfg.max_seq, D), 1.0, cfg.pdtype)
    return p


def vocab_start(cfg: ModelConfig, sh) -> int:
    """The first vocabulary row (embedding) or column (head, logits) this
    rank holds: 0 unless ``sh`` splits the vocabulary over ``model``."""
    ts = sh.tensor_split(cfg) if sh is not None else None
    return ts.rank * (cfg.vocab_padded // ts.size) if ts is not None and ts.vocab else 0


def lm_logits(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              sh=None) -> torch.Tensor:
    """The logits of ``x`` against the head (or the tied embedding).
    Where ``sh`` splits the vocabulary, ``p`` holds this rank's rows of
    ``tok`` / columns of ``head`` and the result is this rank's vocabulary
    columns (..., V_pad/M)."""
    group = split_group(sh, cfg, "vocab")
    if group is not None:
        x = comm.copy_to_model(x, group)
    if cfg.tie_embeddings:
        w = p["tok"].to(cfg.cdtype).t()
    else:
        w = p["head"].to(cfg.cdtype)
    return torch.matmul(x, w)


def _pad_mask(lg: torch.Tensor, cfg: ModelConfig, start: int) -> torch.Tensor:
    """``lg`` (float32, columns ``start`` on) with the pad-vocab columns
    pushed to -1e9 by an additive vector, by their global index."""
    if cfg.vocab_padded == cfg.vocab:
        return lg
    cols = torch.arange(start, start + lg.shape[-1], device=lg.device)
    return lg + torch.where(cols < cfg.vocab, 0.0, -1e9).to(torch.float32)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
               sh=None) -> torch.Tensor:
    group = split_group(sh, cfg, "vocab")
    if group is not None:
        return _token_nll_split(logits, labels, cfg, vocab_start(cfg, sh), group)
    lg = _pad_mask(logits.to(torch.float32), cfg, 0)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return lse - picked


def _token_nll_split(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                     start: int, group) -> torch.Tensor:
    """:func:`_token_nll` of vocabulary-split logits (..., V_pad/M),
    columns ``start`` on: the row maximum is all-reduced (max) over the
    group, then the sums of exponentials and the picked logits (each taken
    on the rank that owns the label, 0 elsewhere) in one summing
    all-reduce.  The maximum carries no gradient: ``lse`` does not depend
    on the shift."""
    lg = _pad_mask(logits.to(torch.float32), cfg, start)
    mx = comm.all_reduce(torch.amax(lg.detach(), dim=-1), group, op=dist.ReduceOp.MAX)
    sums = torch.sum(torch.exp(lg - mx[..., None]), dim=-1)
    local = labels.long() - start
    mine = (local >= 0) & (local < lg.shape[-1])
    picked = torch.gather(lg, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    picked = torch.where(mine, picked, 0.0)
    sums, picked = comm.reduce_from_model(torch.stack([sums, picked]), group).unbind(0)
    return torch.log(sums) + mx - picked


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                  weight: Optional[torch.Tensor] = None, sh=None) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` (..., V_pad) against
    ``labels`` (...), in float32: ``logsumexp - picked`` per token.  The
    pad-vocab columns are masked by an additive float32 (V_pad,) vector of 0
    and -1e9, not by a concatenation, which would materialise a second
    float32 copy of the logits.  With ``weight`` (...), returns
    ``sum(nll * w) / max(sum(w), 1)``.  Where ``sh`` splits the vocabulary
    over ``model``, ``logits`` are this rank's columns (:func:`lm_logits`)
    and every rank of the group gets the same loss."""
    nll = _token_nll(logits, labels, cfg, sh)
    if weight is None:
        return torch.mean(nll)
    w = weight.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                       weight: Optional[torch.Tensor] = None, sh=None):
    """The parts of :func:`cross_entropy` before its division, float32
    scalars: ``(sum(nll * w), sum(w))``, or ``(sum(nll), token count)``
    without ``weight`` (a data-parallel loss sums each over the ranks)."""
    nll = _token_nll(logits, labels, cfg, sh)
    if weight is None:
        return torch.sum(nll), torch.full((), float(nll.numel()), device=nll.device)
    w = weight.to(torch.float32)
    return torch.sum(nll * w), torch.sum(w)
