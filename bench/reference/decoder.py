"""Plain reference of the benchmark's decoder configurations (dense and
sparse-expert decoders, as OLMo and DBRX describe them), in float32 and
plain PyTorch.  It imports nothing of the program: it reads the
configuration's sizes (a dict, the configuration file's ``model``) and a
weight tree laid out as the configuration files state (the benchmark draws
the weights from the seed and hands the same tensors to both sides).

Each product goes through :func:`mm`; ``quant=True`` rounds both of its
operands to fp8 (e4m3, one scale per tensor, round to nearest) first: the
control, the reference computed one precision below the configuration's
bfloat16.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

f32 = torch.float32
FP8_MAX = 448.0  # largest finite float8 e4m3


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one per-tensor scale (amax -> 448)."""
    d = x.detach()
    s = torch.clamp(d.abs().amax(), min=1e-30) / FP8_MAX
    q = (d / s).to(torch.float8_e4m3fn).to(f32) * s
    return x + (q - d)


def mm(a: torch.Tensor, w: torch.Tensor, quant: bool) -> torch.Tensor:
    if quant:
        a, w = fp8(a), fp8(w)
    return torch.matmul(a, w)


def _w(t: torch.Tensor) -> torch.Tensor:
    return t.to(f32)


def norm(p: Dict[str, torch.Tensor], x: torch.Tensor, kind: str, eps: float = 1e-5):
    if kind == "rmsnorm":
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * _w(p["scale"])
    mu = torch.mean(x, -1, keepdim=True)
    y = (x - mu) * torch.rsqrt(torch.mean((x - mu) ** 2, -1, keepdim=True) + eps)
    if kind == "layernorm":
        y = y * _w(p["scale"]) + _w(p["bias"])
    return y  # nonparametric_ln: OLMo's layer norm without scale or bias


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the two halves of each head rotated together
    (GPT-NeoX's layout, as OLMo and DBRX use).  x: (B, T, H, hd)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=f32, device=x.device) / half)
    ang = pos.to(f32)[:, None] * inv  # (T, half)
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def attention(p, x, m: Dict[str, Any], quant: bool) -> torch.Tensor:
    """Causal grouped-query attention with RoPE over x (B, T, D)."""
    B, T, _ = x.shape
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    pos = torch.arange(T, device=x.device)
    theta = m.get("rope_theta", 10000.0)
    q = rope(mm(x, _w(p["wq"]), quant).view(B, T, H, hd), pos, theta)
    k = rope(mm(x, _w(p["wk"]), quant).view(B, T, KV, hd), pos, theta)
    v = mm(x, _w(p["wv"]), quant).view(B, T, KV, hd)
    k = k.repeat_interleave(H // KV, dim=2)  # query head h reads KV head h // (H / KV)
    v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, T, hd)
    s = mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, -1), v, quant)
    return mm(o.transpose(1, 2).reshape(B, T, H * hd), _w(p["wo"]), quant)


def mlp(p, x, quant: bool) -> torch.Tensor:
    """SwiGLU: silu(x W_gate) * (x W_in), then W_out."""
    return mm(F.silu(mm(x, _w(p["w_gate"]), quant)) * mm(x, _w(p["w_in"]), quant),
              _w(p["w_out"]), quant)


def moe(p, x, m: Dict[str, Any], quant: bool, router_bf16: bool = False) -> torch.Tensor:
    """Top-k of a softmax router over the experts, the k gates renormalised
    to sum 1 (DBRX's ``moe_normalize_expert_weights``), each token through
    its k SwiGLU experts, no token dropped.  ``router_bf16`` rounds the
    router's input to bfloat16 first (a witness of how near-ties in the
    top-k move with rounding of that size)."""
    B, T, D = x.shape
    xt = x.reshape(-1, D)
    xr = xt.to(torch.bfloat16).to(f32) if router_bf16 else xt
    probs = torch.softmax(torch.matmul(xr, _w(p["router"])), -1)  # the router in float32
    gates, experts = torch.topk(probs, m["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        ye = mm(F.silu(mm(xe, _w(p["w_gate"][e]), quant)) * mm(xe, _w(p["w_in"][e]), quant),
                _w(p["w_out"][e]), quant)
        out = out.index_add(0, tok, ye * gates[tok, slot][:, None])
    return out.view(B, T, D)


def forward(W: Dict[str, Any], m: Dict[str, Any], tokens: torch.Tensor,
            quant: bool = False, router_bf16: bool = False) -> torch.Tensor:
    """Logits (B, T, V_pad) float32 of ``tokens`` (B, T): embedding,
    pre-norm layers of attention and then the MLP or the experts, final
    norm, the head (the token table's transpose where tied)."""
    kind = m.get("norm", "rmsnorm")
    x = _w(W["embed"]["tok"])[tokens.long()]
    for lp in W["layers"]:
        x = x + attention(lp["attn"], norm(lp["norm1"], x, kind), m, quant)
        h = norm(lp["norm2"], x, kind)
        x = x + (moe(lp["moe"], h, m, quant, router_bf16) if "moe" in lp
                 else mlp(lp["mlp"], h, quant))
    x = norm(W["final_norm"], x, kind)
    head = W["embed"]["tok"].t() if m.get("tie_embeddings") else W["embed"]["head"]
    return mm(x, _w(head), quant)


def token_gaps(W, m, seqs: torch.Tensor, first: int, quant: bool = False,
               router_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """For sequences (R, L) of context and served tokens, the served tokens
    from position ``first`` on: the gap by which each served token's logit
    lies below the best logit at its step (R, L - first), from the
    reference's logits, a row at a time.  With ``quant`` (or
    ``router_bf16``) the reference so changed chooses the token (the one it
    puts first) and the plain reference judges it.  Also returns the chosen
    tokens."""
    V = m["vocab"]
    gaps, chosen = [], []
    with torch.no_grad():
        for row in seqs:
            x = row[None, :-1]
            ref = forward(W, m, x)[:, first - 1:, :V]
            if quant or router_bf16:
                other = forward(W, m, x, quant=quant, router_bf16=router_bf16)
                pick = torch.argmax(other[:, first - 1:, :V], -1)
                del other
            else:
                pick = row[None, first:]
            best = ref.max(-1).values
            got = torch.gather(ref, -1, pick.long()[..., None])[..., 0]
            gaps.append(best - got)
            chosen.append(pick)
            del ref
    return torch.cat(gaps), torch.cat(chosen)
