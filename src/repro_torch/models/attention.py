"""Grouped-query attention with RoPE, sliding windows and KV-cache decode.

Counterpart of ``repro.models.attention``.  The training path avoids
materialising repeated KV heads: queries are reshaped to (B, S, G, Hg, hd)
where G = n_kv_heads groups, so scores contract against the (B, T, G, hd)
keys directly.  Sliding-window archs apply a band mask in training and keep
a rolling window cache in decode.  Cross-attention (the whisper decoder
over projected encoder memory) takes the dense path, as in the reference.

Under a sharding policy that splits the heads over ``model``
(:meth:`~repro_torch.sharding.specs.ShardingPolicy.tensor_split`), each
rank computes its own H/M query heads and the KV heads they read, from
its column slices of ``wq``/``wk``/``wv`` (``wk``/``wv`` whole when the
KV heads do not split, the rank's heads picked from them), and its row
slice of ``wo`` gives a partial output summed over the group.  Decode
follows its cache's split (``kv_split``, :meth:`~repro_torch.sharding.
specs.TensorSplit.kv_cache`): ``"heads"`` as above; ``"time"``, where each
rank holds a slice of the slots of every KV head, attends every query head
over its own slots and combines the ranks' partial softmaxes
(:func:`~repro_torch.sharding.comm.softmax_combine`), then takes ``wo``'s
rows of its query heads where they split; ``"whole"`` repeats it all.

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

from .. import spans
from ..kernels import ops as kops
from ..sharding import comm
from .config import ModelConfig
from .layers import rope, split_group, trunc_normal

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


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig, ts=None):
    """q (B, S, H, hd) and k, v (B, S, KV, hd) of ``x``; under a head split
    (``ts``, a :class:`~repro_torch.sharding.specs.TensorSplit`) this
    rank's H/M query heads and the KV heads they read."""
    B, S, _ = x.shape
    q = torch.matmul(x, p["wq"].to(cfg.cdtype)).reshape(B, S, -1, cfg.hd)
    return (q, *_kv_proj(p, x, cfg, ts))


def _kv_proj(p: Params, x: torch.Tensor, cfg: ModelConfig,
             ts=None) -> Tuple[torch.Tensor, ...]:
    """K, V (B, T, KV, hd) of ``x``.  Under a head split (``ts``), this
    rank's (B, T, KV_loc, hd): from its column slices of ``wk``/``wv`` when
    the KV heads split, else from the columns of the KV heads its query
    heads read (``TensorSplit.kv_heads``)."""
    B, T, _ = x.shape
    hd = cfg.hd
    out = []
    for name in ("wk", "wv"):
        w = p[name]
        if ts is not None and not ts.kv:
            heads, _ = ts.kv_heads(cfg.n_heads, cfg.n_kv_heads)
            w = w.reshape(w.shape[0], cfg.n_kv_heads, hd)
            w = (w[:, heads[0]:heads[-1] + 1] if heads == list(range(heads[0], heads[-1] + 1))
                 else w[:, torch.tensor(heads, device=w.device)]).reshape(w.shape[0], -1)
        out.append(torch.matmul(x, w.to(cfg.cdtype)).reshape(B, T, -1, hd))
    return tuple(out)


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
    """Full-sequence attention of x (B, S, D) at ``positions``.  ``sh``: a
    sharding policy (module docstring: the heads split over ``model``)."""
    group = split_group(sh, cfg, "heads")
    if group is None:
        q, k, v = _qkv(p, x, cfg)
    else:
        x = comm.copy_to_model(x, group)
        q, k, v = _qkv(p, x, cfg, sh.tensor_split(cfg))
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    if cfg.attn_impl == "pallas" and window == 0:
        B, _, H, hd = q.shape
        KV = k.shape[2]
        # interleave query-head groups so the heads sharing a KV head are
        # adjacent, where the kernel's h // n_rep finds their KV head (on a
        # rank of a head split: its own heads and KV heads)
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
    out = torch.matmul(out, p["wo"].to(cfg.cdtype))
    return out if group is None else comm.reduce_from_model(out, group)


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


def _attend_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], cfg: ModelConfig, group=None) -> torch.Tensor:
    """:func:`_sdpa` of q (B, S, H, hd) over a cache k, v (B, T, KV, hd);
    with ``group``, the cache is this rank's slice of the time axis and the
    ranks' partial softmaxes are combined (float32 throughout)."""
    if group is None:
        return _sdpa(q, k, v, mask, cfg)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bsghd,btgd->bghst", qg, k).to(torch.float32) / math.sqrt(hd)
    if mask is not None:
        s = s + (mask if mask.dim() == 3 else mask[None])[:, None, None, :, :]
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bghst,btgd->bghsd", p, v.to(torch.float32))
    out = comm.softmax_combine(m, torch.sum(p, dim=-1), o, group)  # (B, KV, Hg, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(cfg.cdtype)


def _split_mode(sh, cfg: ModelConfig, kv_split: Optional[str]):
    """(the tensor split or None, the attention's mode): off a split the
    mode is ``"whole"``; under one, ``kv_split`` (decode's cache split) or
    the training rule (``"heads"`` when the heads split)."""
    ts = sh.tensor_split(cfg) if sh is not None else None
    if ts is None:
        return None, "whole"
    return ts, kv_split or ("heads" if ts.heads else "whole")


def _out_proj(out: torch.Tensor, p: Params, cfg: ModelConfig, ts, mode: str, group):
    """``out`` (B, S, H * hd) through ``wo``: this rank's query heads'
    rows summed over ``model`` where the heads split (a ``"time"`` split's
    ``out`` holds every head: this rank's columns are taken first)."""
    split = ts is not None and (mode == "heads" or (mode == "time" and ts.heads))
    if split and mode == "time":
        out = out[..., ts.part(out.shape[-1])]
    out = torch.matmul(out, p["wo"].to(cfg.cdtype))
    return comm.reduce_from_model(out, group) if split else out


def attention_decode(
    p: Params,
    x: torch.Tensor,  # (B, 1, D) the new token's activation
    cache_k: torch.Tensor,  # (B, T, KV, hd) this layer's cache
    cache_v: torch.Tensor,
    pos: int,  # index of the new token
    cfg: ModelConfig,
    *,
    window: int = 0,
    sh=None,
    kv_split: Optional[str] = None,
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

    ``sh``: a sharding policy; under a split over ``model``, ``kv_split``
    says how the cache splits (module docstring) and is required.  Under a
    ``"time"`` split ``T`` is the whole cache's length, this rank's slice
    ``T/M`` slots from ``rank * T/M``: only the rank that holds the write
    slot writes it, and key validity comes from each slot's global index.
    """
    ts, mode = _split_mode(sh, cfg, kv_split)
    if ts is not None and kv_split is None:
        raise ValueError("attention_decode over a model split needs kv_split, the cache's "
                         "split (TensorSplit.kv_cache)")
    group = sh.model_group() if ts is not None else None
    with spans.span("attn"):
        with spans.span("attn.qkv"):
            q, k, v = _qkv(p, x, cfg, ts if mode == "heads" else None)  # (B, 1, ...)
            if cfg.pos == "rope":
                posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
                q = rope(q, posv, cfg.rope_theta)
                k = rope(k, posv, cfg.rope_theta)
        T_loc = cache_k.shape[1]
        first, T = (ts.rank * T_loc, T_loc * ts.size) if mode == "time" else (0, T_loc)
        slot = (pos % T) if window else min(max(pos, 0), T - 1)
        with spans.span("attn.cache_write"):
            if first <= slot < first + T_loc:  # this rank holds the write slot
                cache_k[:, slot - first] = k[:, 0]
                cache_v[:, slot - first] = v[:, 0]
        with spans.span("attn.cache_read"):
            # slots that hold a position <= pos: the first min(pos + 1, T) of
            # the whole cache, rolling window or not; this rank's share of them
            spans.note("rows", x.shape[0])
            spans.note("slots_valid", max(0, min(pos + 1, first + T_loc) - first))
            spans.note("slots", T_loc)
            # key validity: slot j holds absolute position (for rolling buffers the
            # newest T positions), attendable iff its absolute position <= pos
            j = torch.arange(first, first + T_loc, device=x.device)
            if window:
                # rolling: absolute position of slot j is the largest value <= pos
                # congruent to j (mod T); valid once written (pos - abs < window <= T)
                abs_pos = pos - torch.remainder(pos - j, T)
                valid = abs_pos >= 0
            else:
                valid = j <= pos
            mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, :]
            out = _attend_cache(q, cache_k, cache_v, mask, cfg, group if mode == "time" else None)
        with spans.span("attn.out_proj"):
            out = _out_proj(out, p, cfg, ts, mode, group)
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
    kv_split: Optional[str] = None,
) -> torch.Tensor:
    """Attention of the decoder's x over the projected encoder memory, no
    mask (every query sees every frame); the dense path whatever
    ``cfg.attn_impl`` is, as in the reference (S != T).  Under a head split
    (``sh``), ``mem_k``/``mem_v`` are this rank's (:func:`project_memory`
    with the same ``sh``); in decode ``kv_split`` is the memory cache's
    split, as in :func:`attention_decode`."""
    B, S, _ = x.shape
    ts, mode = _split_mode(sh, cfg, kv_split)
    group = sh.model_group() if ts is not None else None
    if mode == "heads":
        x = comm.copy_to_model(x, group)
    q = torch.matmul(x, p["wq"].to(cfg.cdtype)).reshape(B, S, -1, cfg.hd)
    out = _attend_cache(q, mem_k, mem_v, None, cfg, group if mode == "time" else None)
    if sh is not None:
        out = sh.act_heads(out)
    return _out_proj(out, p, cfg, ts, mode, group)


def project_memory(p: Params, mem: torch.Tensor, cfg: ModelConfig,
                   sh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output (B, T, D) projected once to K, V (B, T, KV, hd);
    reused by every decode step.  Under a head split (``sh``), this rank's
    KV heads (KV_loc)."""
    group = split_group(sh, cfg, "heads")
    if group is None:
        return _kv_proj(p, mem, cfg)
    return _kv_proj(p, comm.copy_to_model(mem, group), cfg, sh.tensor_split(cfg))
