"""Grouped-query attention with RoPE, sliding windows and KV-cache decode.

Counterpart of ``repro.models.attention``.  The training path avoids
materialising repeated KV heads: queries are reshaped to (B, S, G, Hg, hd)
where G = n_kv_heads groups, so scores contract against the (B, T, G, hd)
keys directly.  Sliding-window archs apply a band mask in training and keep
a rolling window cache in decode.  Cross-attention (the whisper decoder
over projected encoder memory) takes the dense path, as in the reference.

``cfg.attn_impl`` picks the full-sequence algorithm: ``"dense"`` (the whole
score matrix), ``"chunked"`` (online softmax over key chunks) or
``"pallas"``, the hand-written Hopper flash kernel through
:func:`repro_torch.kernels.ops.attention` (its plain version on CPU tensors;
windowed layers take the dense path, as in the reference).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import rope, trunc_normal

__all__ = [
    "attn_params",
    "attention_train",
    "attention_decode",
    "init_kv_cache",
    "cross_attention",
    "project_memory",
]

NEG_INF = -1e9

Params = Dict[str, torch.Tensor]


def attn_params(gen: torch.Generator, cfg: ModelConfig, d_in: Optional[int] = None) -> Params:
    D = d_in or cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": trunc_normal(gen, (D, H * hd), 1.0, cfg.pdtype),
        "wk": trunc_normal(gen, (D, KV * hd), 1.0, cfg.pdtype),
        "wv": trunc_normal(gen, (D, KV * hd), 1.0, cfg.pdtype),
        "wo": trunc_normal(gen, (H * hd, D), 1.0, cfg.pdtype),
    }


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.matmul(x, p["wq"].to(cfg.cdtype)).reshape(B, S, H, hd)
    k = torch.matmul(x, p["wk"].to(cfg.cdtype)).reshape(B, S, KV, hd)
    v = torch.matmul(x, p["wv"].to(cfg.cdtype)).reshape(B, S, KV, hd)
    return q, k, v


def _band_mask(S: int, T: int, offset: int, window: int, causal: bool,
               device: torch.device, k_offset: int = 0) -> torch.Tensor:
    """(S, T) additive float32 mask.  query position i attends key position
    j iff (not causal or j+k_offset <= i+offset) and (window == 0 or
    i+offset-(j+k_offset) < window)."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :] + k_offset
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= (qi - kj) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,  # (B, T, KV, hd)
    mask: Optional[torch.Tensor],  # (S, T) additive or (B, S, T)
    cfg: ModelConfig,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    Hg = H // KV
    qg = q.reshape(B, S, KV, Hg, hd)
    scores = torch.einsum("bsghd,btgd->bghst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = scores + m[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(cfg.cdtype)
    out = torch.einsum("bghst,btgd->bsghd", probs, v)
    return out.reshape(B, S, H * hd)


def _sdpa_chunked(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool,
    window: int,
    n_chunks: int = 8,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks (float32 running max,
    denominator and accumulator); never materialises the (S, T) scores."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    while T % n_chunks:
        n_chunks -= 1
    Tc = T // n_chunks
    Hg = H // KV
    qg = q.reshape(B, S, KV, Hg, hd)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    m = torch.full((B, KV, Hg, S), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, Hg, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, Hg, S, hd), dtype=torch.float32, device=dev)
    for j in range(n_chunks):
        kj = k[:, j * Tc : (j + 1) * Tc]
        vj = v[:, j * Tc : (j + 1) * Tc]
        s = torch.einsum("bsghd,btgd->bghst", qg, kj).to(torch.float32) * scale
        if causal or window:
            s = s + _band_mask(S, Tc, 0, window, causal, dev, k_offset=j * Tc)[None, None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bghst,btgd->bghsd", p.to(cfg.cdtype), vj
        ).to(torch.float32)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(cfg.cdtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)  # (B,S,KV,Hg,hd)->(B,S,E)


def attention_train(
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int = 0,
    sh=None,
) -> torch.Tensor:
    """Full-sequence attention of x (B, S, D) at ``positions``.  ``sh``: the
    reference's sharding policy (its ``act_heads`` is an identity here)."""
    q, k, v = _qkv(p, x, cfg)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    if cfg.attn_impl == "pallas" and window == 0:
        B, _, H, hd = q.shape
        KV = k.shape[2]
        # interleave query-head groups so the heads sharing a KV head are
        # adjacent, where the kernel's h // n_rep finds their KV head
        qf = q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4).reshape(B * H, S, hd)
        kf = k.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
        vf = v.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
        of = kops.attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                            causal=causal, n_rep=H // KV)
        out = of.reshape(B, KV, H // KV, S, hd).permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    elif cfg.attn_impl == "chunked":
        out = _sdpa_chunked(q, k, v, cfg, causal=causal, window=window)
    else:
        mask = _band_mask(S, S, 0, window, causal, x.device) if (causal or window) else None
        out = _sdpa(q, k, v, mask, cfg)
    if sh is not None:
        out = sh.act_heads(out)
    return torch.matmul(out, p["wo"].to(cfg.cdtype))


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, layers: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    KV, hd = cfg.n_kv_heads, cfg.hd
    shape = (layers, batch, length, KV, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.cdtype, device=device),
    }


def attention_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, D) the new token's activation
    cache_k: torch.Tensor,  # (B, T, KV, hd) this layer's cache
    cache_v: torch.Tensor,
    pos: int,  # index of the new token
    cfg: ModelConfig,
    *,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step.  Returns (out, cache_k, cache_v).

    The new K/V are written into ``cache_k`` / ``cache_v`` IN PLACE (the
    returned caches are the same tensors): the reference's functional
    ``dynamic_update_slice`` would copy the whole cache every step at full
    width.  The write slot is ``pos``, clamped to ``T - 1`` as
    ``dynamic_update_slice`` clamps an out-of-range start, so a step at
    ``pos >= T`` overwrites the last slot.  For sliding-window layers the
    cache is a rolling buffer of size ``window``: the slot is ``pos % T``
    and key positions are reconstructed from the rolling layout, so memory
    is O(window) however long the stream.  ``pos`` is a host int, so no
    step waits on the device for it.
    """
    T = cache_k.shape[1]
    q, k, v = _qkv(p, x, cfg)  # (B, 1, ...)
    if cfg.pos == "rope":
        posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, posv, cfg.rope_theta)
        k = rope(k, posv, cfg.rope_theta)
    slot = (pos % T) if window else min(max(pos, 0), T - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    # key validity: slot j holds absolute position (for rolling buffers the
    # newest T positions), attendable iff its absolute position <= pos
    j = torch.arange(T, device=x.device)
    if window:
        # rolling: absolute position of slot j is the largest value <= pos
        # congruent to j (mod T); valid once written (pos - abs < window <= T)
        abs_pos = pos - torch.remainder(pos - j, T)
        valid = abs_pos >= 0
    else:
        valid = j <= pos
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, :]
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    out = torch.matmul(out, p["wo"].to(cfg.cdtype))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attention(
    p: Params,
    x: torch.Tensor,  # (B, S, D) decoder activations
    mem_k: torch.Tensor,  # (B, T, KV, hd) projected encoder keys
    mem_v: torch.Tensor,
    cfg: ModelConfig,
    sh=None,
) -> torch.Tensor:
    """Attention of the decoder's x over the projected encoder memory, no
    mask (every query sees every frame); the dense path whatever
    ``cfg.attn_impl`` is, as in the reference (S != T)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = torch.matmul(x, p["wq"].to(cfg.cdtype)).reshape(B, S, H, hd)
    out = _sdpa(q, mem_k, mem_v, None, cfg)
    if sh is not None:
        out = sh.act_heads(out)
    return torch.matmul(out, p["wo"].to(cfg.cdtype))


def project_memory(p: Params, mem: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, T, D) projected once to K, V (B, T, KV, hd);
    reused by every decode step."""
    B, T, _ = mem.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = torch.matmul(mem, p["wk"].to(cfg.cdtype)).reshape(B, T, KV, hd)
    v = torch.matmul(mem, p["wv"].to(cfg.cdtype)).reshape(B, T, KV, hd)
    return k, v
