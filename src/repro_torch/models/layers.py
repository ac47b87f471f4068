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
import torch.nn.functional as F

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


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              sh=None) -> torch.Tensor:
    """SwiGLU or GELU (tanh approximation, as ``jax.nn.gelu``'s default);
    the activation in float32, the products in the compute dtype.  ``sh``:
    the reference's sharding policy (its ``act_ff`` is an identity here)."""
    h = torch.matmul(x, p["w_in"].to(cfg.cdtype))
    if cfg.activation == "swiglu":
        g = torch.matmul(x, p["w_gate"].to(cfg.cdtype))
        h = F.silu(g.to(torch.float32)).to(cfg.cdtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(cfg.cdtype)
    if sh is not None:
        h = sh.act_ff(h)
    return torch.matmul(h, p["w_out"].to(cfg.cdtype))


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


def lm_logits(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["tok"].to(cfg.cdtype).t()
    else:
        w = p["head"].to(cfg.cdtype)
    return torch.matmul(x, w)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    lg = logits.to(torch.float32)
    if cfg.vocab_padded != cfg.vocab:
        cols = torch.arange(cfg.vocab_padded, device=lg.device)
        lg = lg + torch.where(cols < cfg.vocab, 0.0, -1e9).to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return lse - picked


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` (..., V_pad) against
    ``labels`` (...), in float32: ``logsumexp - picked`` per token.  The
    pad-vocab columns are masked by an additive float32 (V_pad,) vector of 0
    and -1e9, not by a concatenation, which would materialise a second
    float32 copy of the logits.  With ``weight`` (...), returns
    ``sum(nll * w) / max(sum(w), 1)``."""
    nll = _token_nll(logits, labels, cfg)
    if weight is None:
        return torch.mean(nll)
    w = weight.to(torch.float32)
    return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
                       weight: Optional[torch.Tensor] = None):
    """The parts of :func:`cross_entropy` before its division, float32
    scalars: ``(sum(nll * w), sum(w))``, or ``(sum(nll), token count)``
    without ``weight`` (a data-parallel loss sums each over the ranks)."""
    nll = _token_nll(logits, labels, cfg)
    if weight is None:
        return torch.sum(nll), torch.full((), float(nll.numel()), device=nll.device)
    w = weight.to(torch.float32)
    return torch.sum(nll * w), torch.sum(w)
