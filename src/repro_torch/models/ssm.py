"""State-space / linear-recurrence blocks: RWKV-6 (Finch) and Mamba.

Counterpart of ``repro.models.ssm``.  RWKV-6 is the attention-free arch
(rwkv6-3b); Mamba heads run in parallel with attention heads inside hymba
layers.  The reference writes each recurrence as a ``lax.scan``; here the
scans are Python loops over time steps (RWKV's chunked form: over chunks of
16) whose step outputs are stacked once after the loop, with no host sync
inside them.  The work that does not wait on the carried state (decay
factors, the intra-chunk products, the chunks' state updates, Mamba's
outputs y_t = h_t C_t) runs for every step at once, outside the loop.

Numerics follow the reference on purpose, rounding where it rounds:

- projections run in the compute dtype; the gate, the decay, both
  recurrences, the group norm and the conv run in float32;
- ``_wkv_chunked`` works from ``log(max(w, 1e-38))`` of the float32 decay
  (not the clamped ``logw``), pads r, k, v with 0 and w with 1.0 to a
  multiple of the chunk, and keeps the reference's decomposition (inter,
  strict-lower-triangle intra, the ``u`` bonus, the state through
  ``exp(total - cum)``);
- ``_group_norm`` takes the population variance (the mean of squared
  deviations, as ``jnp.var``);
- Mamba's causal depthwise conv is the reference's sum of four shifted
  float32 products, in order; ``F.conv1d`` would sum in another order (and
  in TF32 on the card by default).

Decode is a single recurrence step: state in, state out.  The states live
on an explicit device (``rwkv_init_state`` / ``mamba_init_state``).

The three loops are functional (no ``out=``, no in-place adds), so that
autograd differentiates them for training; serving runs the same code.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import trunc_normal

__all__ = [
    "rwkv_params",
    "rwkv_train",
    "rwkv_decode",
    "rwkv_init_state",
    "rwkv_channel_params",
    "rwkv_channel_mix",
    "mamba_params",
    "mamba_train",
    "mamba_decode",
    "mamba_init_state",
]

LORA_DECAY = 64
LORA_MIX = 32
CONV_W = 4

Params = Dict[str, torch.Tensor]
f32 = torch.float32


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch"): data-dependent decay linear attention
# ---------------------------------------------------------------------------


def rwkv_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D = cfg.d_model
    H = cfg.n_rwkv_heads
    hd = D // H
    dt, dev = cfg.pdtype, gen.device
    return {
        # token-shift base mixes for r, k, v, w, g
        "mu": torch.zeros((5, D), dtype=dt, device=dev),
        # per-channel decay base, spread across the head dim
        "w0": torch.linspace(-6.0, -1.0, hd, device=dev).repeat(H).to(dt),
        "wA": trunc_normal(gen, (D, LORA_DECAY), 0.1, dt),
        "wB": trunc_normal(gen, (LORA_DECAY, D), 0.1, dt),
        "u": trunc_normal(gen, (D,), 1.0, dt),  # bonus for the current token
        "wr": trunc_normal(gen, (D, D), 1.0, dt),
        "wk": trunc_normal(gen, (D, D), 1.0, dt),
        "wv": trunc_normal(gen, (D, D), 1.0, dt),
        "wg": trunc_normal(gen, (D, D), 1.0, dt),
        "wo": trunc_normal(gen, (D, D), 1.0, dt),
        "gn_scale": torch.ones((D,), dtype=dt, device=dev),  # per-head group norm
    }


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: each position minus its predecessor's input, the first
    position's predecessor being the carried ``x_prev`` (B, 1, D)."""
    return torch.cat([x_prev, x[:, :-1]], dim=1) - x


def _rwkv_inputs(p: Params, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """Token shift + projections.  x: (B, S, D); x_prev: (B, 1, D) carry.
    Returns (r, k, v, g, w, logw)."""
    cd = cfg.cdtype
    xx = _shift(x, x_prev)
    mu = p["mu"].to(cd)
    xr, xk, xv, xw, xg = (x + xx * mu[i] for i in range(5))
    r = torch.matmul(xr, p["wr"].to(cd))
    k = torch.matmul(xk, p["wk"].to(cd))
    v = torch.matmul(xv, p["wv"].to(cd))
    g = F.silu(torch.matmul(xg, p["wg"].to(cd)).to(f32))
    # data-dependent decay (f32 for stability)
    lora = torch.matmul(torch.tanh(torch.matmul(xw, p["wA"].to(cd))).to(cd), p["wB"].to(cd))
    logw = -torch.exp(p["w0"].to(f32) + lora.to(f32))  # < 0
    # the reference's clamp: keeps the chunked form's exp(-cum) factors
    # inside float32 range (chunk 16 * 4.0 << 88)
    logw = torch.clamp(logw, min=-4.0)
    return r, k, v, g, torch.exp(logw), logw


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, S, D = x.shape
    return x.reshape(B, S, H, D // H)


def _group_norm(o: torch.Tensor, scale: torch.Tensor, H: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm (RWKV's GroupNorm over heads); o: (B, S, H, hd).
    The variance is the population variance, as ``jnp.var``'s."""
    B, S, _, hd = o.shape
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.mean(torch.square(o - mu), dim=-1, keepdim=True)
    o = (o - mu) * torch.rsqrt(var + eps)
    return o.reshape(B, S, H * hd) * scale


def rwkv_init_state(cfg: ModelConfig, batch: int, layers: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    H = cfg.n_rwkv_heads
    hd = D // H
    shift = (layers, batch, 1, D)
    return {
        "wkv": torch.zeros((layers, batch, H, hd, hd), dtype=f32, device=device),
        "x_tm": torch.zeros(shift, dtype=cfg.cdtype, device=device),  # time-mix shift
        "x_cm": torch.zeros(shift, dtype=cfg.cdtype, device=device),  # channel-mix shift
    }


def _wkv_scan(r, k, v, w, u, state0):
    """Exact recurrence.  r, k, v, w: (B, S, H, hd); u: (H, hd); state0
    (B, H, hd, hd) float32.  Returns (o (B, S, H, hd) float32, final state).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t ;  o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    """
    B, S, H, hd = r.shape
    # time-major, so each step reads contiguous (B, H, hd) slices
    rs, ks, vs, ws = (a.to(f32).transpose(0, 1).contiguous() for a in (r, k, v, w))
    u3 = u[:, :, None]  # (H, hd_k, 1)
    outs = []
    St = state0
    for r_t, k_t, v_t, w_t in zip(rs.unbind(0), ks.unbind(0), vs.unbind(0), ws.unbind(0)):
        kv = k_t[..., None] * v_t[..., None, :]  # rank-1 update (B, H, hd, hd)
        outs.append(torch.matmul(r_t[..., None, :], St + u3 * kv))
        St = w_t[..., None] * St + kv
    out = torch.stack(outs) if outs else rs.new_empty((S, B, H, 1, hd))
    return out.reshape(S, B, H, hd).transpose(0, 1), St


def _wkv_chunked(r, k, v, w, u, state0, chunk: int = 16):
    """Chunked parallel form (GLA-style): intra-chunk via masked products,
    inter-chunk via the carried state.  Matches ``_wkv_scan`` to ~1e-4.
    Shapes as :func:`_wkv_scan`.  Only the inter-chunk product and the
    state update wait on the carried state; they are the loop."""
    B, S, H, hd = r.shape
    if S % chunk:
        pad = (0, 0, 0, 0, 0, chunk - S % chunk)
        r, k, v = F.pad(r, pad), F.pad(k, pad), F.pad(v, pad)
        w = F.pad(w, pad, value=1.0)
    n = r.shape[1] // chunk

    def blocks(a):  # (B, n*C, H, hd) -> (n, B, H, C, hd), chunk-major
        return a.to(f32).reshape(B, n, chunk, H, hd).permute(1, 0, 3, 2, 4).contiguous()

    rs, ks, vs, ws = blocks(r), blocks(k), blocks(v), blocks(w)
    logw = torch.log(torch.clamp(ws, min=1e-38))
    cum = torch.cumsum(logw, dim=3)  # log prod_{s<=t} w_s within the chunk
    # decay-adjusted operands
    r_in = rs * torch.exp(cum - logw)  # queries see the state through decay
    k_dec = ks * torch.exp(-cum)  # keys forward-decayed
    # state update: S' = diag(prod w) S + sum_s diag(prod_{>s} w) k_s v_s
    total = cum[:, :, :, -1:, :]  # (n, B, H, 1, hd)
    kv = torch.matmul((ks * torch.exp(total - cum)).transpose(-1, -2), vs)  # (n, B, H, hd, hd)
    decay = torch.exp(total).transpose(-1, -2)  # (n, B, H, hd, 1)
    inters = []
    St = state0
    for r_i, d_i, kv_i in zip(r_in.unbind(0), decay.unbind(0), kv.unbind(0)):
        inters.append(torch.matmul(r_i, St))  # inter-chunk: r_t . S
        St = d_i * St + kv_i
    # intra-chunk: strict lower triangle, then the bonus diagonal, added in
    # the reference's order, (inter + intra) + bonus
    tri = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=r.device), -1)
    intra = torch.matmul(torch.matmul(r_in, k_dec.transpose(-1, -2)) * tri, vs)
    bonus = torch.sum(rs * (u[:, None, :] * ks), dim=-1, keepdim=True) * vs
    out = (torch.stack(inters) if inters else torch.empty_like(rs)) + intra + bonus
    o = out.permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, hd)
    return o[:, :S], St


def rwkv_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Dict[str, torch.Tensor]] = None, *,
               impl: str = "scan") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Time-mix block.  x: (B, S, D) (already normed).  Returns (out,
    state); ``state`` ({"x_tm", "wkv"}) is read, never written."""
    B, S, D = x.shape
    H = cfg.n_rwkv_heads
    hd = D // H
    x_prev = state["x_tm"] if state else torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
    S0 = state["wkv"] if state else torch.zeros((B, H, hd, hd), dtype=f32, device=x.device)
    r, k, v, g, w, _ = _rwkv_inputs(p, x, x_prev, cfg)
    rh, kh, vh, wh = (_heads(a, H) for a in (r, k, v, w))
    u = p["u"].to(f32).reshape(H, hd)
    wkv = _wkv_chunked if impl == "chunked" else _wkv_scan
    o, S1 = wkv(rh, kh, vh, wh, u, S0)
    o = _group_norm(o, p["gn_scale"].to(f32), H)
    o = (o * g).to(cfg.cdtype)
    out = torch.matmul(o, p["wo"].to(cfg.cdtype))
    return out, {"x_tm": x[:, -1:], "wkv": S1}


def rwkv_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ModelConfig):
    """One-token step; x: (B, 1, D).  O(1) in stream length."""
    return rwkv_train(p, x, cfg, state=state, impl="scan")


def rwkv_channel_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.zeros((2, D), dtype=cfg.pdtype, device=gen.device),  # shifts for k and r
        "wk": trunc_normal(gen, (D, F_), 1.0, cfg.pdtype),
        "wv": trunc_normal(gen, (F_, D), 1.0, cfg.pdtype),
        "wr": trunc_normal(gen, (D, D), 1.0, cfg.pdtype),
    }


def rwkv_channel_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor, cfg: ModelConfig):
    """Channel mix of x (B, S, D) with the carried shift x_prev (B, 1, D).
    Returns (out, x[:, -1:])."""
    cd = cfg.cdtype
    xx = _shift(x, x_prev)
    mu = p["mu"].to(cd)
    xk, xr = x + xx * mu[0], x + xx * mu[1]
    k = torch.matmul(xk, p["wk"].to(cd))
    k = torch.square(F.relu(k.to(f32))).to(cd)
    kv = torch.matmul(k, p["wv"].to(cd))
    r = torch.sigmoid(torch.matmul(xr, p["wr"].to(cd)).to(f32))
    return (r * kv.to(f32)).to(cd), x[:, -1:]


# ---------------------------------------------------------------------------
# Mamba (selective SSM) -- the SSM half of hymba layers
# ---------------------------------------------------------------------------


def mamba_params(gen: torch.Generator, cfg: ModelConfig, d_in: Optional[int] = None) -> Params:
    D = d_in or cfg.d_model
    Di = D  # inner width (hymba runs SSM heads parallel to attn; keep = D)
    N = cfg.ssm_state
    dt_rank = max(1, math.ceil(D / 16))
    dt, dev = cfg.pdtype, gen.device
    return {
        "in_proj": trunc_normal(gen, (D, 2 * Di), 1.0, dt),
        "conv_w": trunc_normal(gen, (CONV_W, Di), 1.0, dt),
        "x_proj": trunc_normal(gen, (Di, dt_rank + 2 * N), 1.0, dt),
        "dt_proj": trunc_normal(gen, (dt_rank, Di), 1.0, dt),
        "dt_bias": torch.log(torch.expm1(torch.full((Di,), 0.01, device=dev))).to(dt),
        "A_log": torch.log(torch.arange(1, N + 1, dtype=f32, device=dev)).repeat(Di, 1).to(dt),
        "D": torch.ones((Di,), dtype=dt, device=dev),
        "out_proj": trunc_normal(gen, (Di, D), 1.0, dt),
    }


def mamba_init_state(cfg: ModelConfig, batch: int, layers: int, device: torch.device,
                     d_in: Optional[int] = None) -> Dict[str, torch.Tensor]:
    Di = d_in or cfg.d_model
    N = cfg.ssm_state
    return {
        "h": torch.zeros((layers, batch, Di, N), dtype=f32, device=device),
        "conv": torch.zeros((layers, batch, CONV_W - 1, Di), dtype=f32, device=device),
    }


def _causal_conv(x: torch.Tensor, conv_prev: torch.Tensor, conv_w: torch.Tensor):
    """Causal depthwise conv of x (B, S, Di), width CONV_W, with the carried
    left context conv_prev (B, CONV_W - 1, Di), then SiLU.  The carry is
    cast to x's dtype first, as the reference casts it; the products are
    summed in float32 one after another.  Returns (silu(conv) float32, the
    next carry float32)."""
    xc = torch.cat([conv_prev.to(x.dtype), x], dim=1)  # (B, S+3, Di)
    w = conv_w.to(f32)
    S = x.shape[1]
    y = xc[:, 0:S].to(f32) * w[0]
    for i in range(1, CONV_W):
        y = y + xc[:, i : i + S].to(f32) * w[i]
    return F.silu(y), xc[:, -(CONV_W - 1):].to(f32)


def _ssm_inputs(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x_proj (compute dtype), dt and the discretisation (float32) of the
    conv output x (B, S, Di).  Returns time-major dA, dBx (S, B, Di, N) and
    C (S, B, N, 1)."""
    N = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]
    proj = torch.matmul(x.to(cfg.cdtype), p["x_proj"].to(cfg.cdtype)).to(f32)
    dt_in, Bc, Cc = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(torch.matmul(dt_in, p["dt_proj"].to(f32)) + p["dt_bias"].to(f32))  # (B, S, Di)
    A = -torch.exp(p["A_log"].to(f32))  # (Di, N)
    # time-major, so each scan step reads contiguous (B, Di, N) slices
    dt_t, x_t = dt.transpose(0, 1)[..., None], x.transpose(0, 1)[..., None]  # (S, B, Di, 1)
    dA = torch.exp(dt_t * A)
    dBx = dt_t * Bc.transpose(0, 1)[:, :, None, :] * x_t
    return dA, dBx, Cc.transpose(0, 1)[..., None].contiguous()


def _selective_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor, h0: torch.Tensor):
    """h_t = dA_t h_{t-1} + dBx_t ; y_t = h_t C_t.  dA, dBx: (S, B, Di, N);
    C: (S, B, N, 1); h0 (B, Di, N).  Returns (y (B, S, Di), h_S)."""
    h = h0
    hs = []
    for a_t, b_t in zip(dA.unbind(0), dBx.unbind(0)):
        h = a_t * h + b_t  # the reference's dA_t h + dBx_t, two launches a step
        hs.append(h)
    states = torch.stack(hs) if hs else dBx
    ys = torch.matmul(states, C)  # every step's h_t C_t at once
    return ys[..., 0].transpose(0, 1), h


def _mamba_core(p: Params, xz: torch.Tensor, conv_prev: torch.Tensor, h0: torch.Tensor,
                cfg: ModelConfig):
    """xz: (B, S, 2*Di) after in_proj; returns (y (B, S, Di) in the compute
    dtype, h_T (B, Di, N) float32, conv tail (B, CONV_W - 1, Di) float32)."""
    Di = xz.shape[-1] // 2
    x, z = xz[..., :Di], xz[..., Di:]
    x, conv_tail = _causal_conv(x, conv_prev, p["conv_w"])
    ys, hT = _selective_scan(*_ssm_inputs(p, x, cfg), h0)
    out = (ys + x * p["D"].to(f32)) * F.silu(z.to(f32))
    return out.to(cfg.cdtype), hT, conv_tail


def mamba_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mamba block of x (B, S, D).  Returns (out, state); ``state`` ({"h",
    "conv"}) is read, never written."""
    B, S, D = x.shape
    Di = p["out_proj"].shape[0]
    xz = torch.matmul(x, p["in_proj"].to(cfg.cdtype))
    conv_prev = state["conv"] if state else torch.zeros((B, CONV_W - 1, Di), dtype=f32,
                                                        device=x.device)
    h0 = state["h"] if state else torch.zeros((B, Di, cfg.ssm_state), dtype=f32, device=x.device)
    y, hT, conv_tail = _mamba_core(p, xz, conv_prev, h0, cfg)
    out = torch.matmul(y, p["out_proj"].to(cfg.cdtype))
    return out, {"h": hT, "conv": conv_tail}


def mamba_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ModelConfig):
    return mamba_train(p, x, cfg, state=state)
