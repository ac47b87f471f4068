"""The model zoo's dense, MoE, SSM and hybrid families: one functional
model over plain parameter dicts.

Counterpart of ``repro.models.model`` for ``family == "dense"`` (olmo-1b,
llama3-405b, phi3-medium-14b, stablelm-1.6b; sliding windows included),
``family == "moe"`` (qwen3-moe-30b-a3b, dbrx-132b: the FFN is
:func:`repro_torch.models.moe.moe_apply`), ``family == "ssm"`` (rwkv6-3b:
RWKV-6 time and channel mix, :mod:`repro_torch.models.ssm`) and ``family ==
"hybrid"`` (hymba-1.5b: windowed attention and Mamba heads in parallel,
mean-fused).  The reference scans stacked layers with ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts and the layers run in a
Python loop.  The remat and sharding knobs are training-only and not
ported.  The other families raise :class:`NotImplementedError` naming the
ROADMAP item that ports them.

Entry points: ``init_params``, ``forward`` (logits; the serving prefill),
``init_decode_state`` / ``decode_step`` (single-token serving).  Parameters
keep the reference's layout, so :func:`repro_torch.core.convert.
params_from_jax` carries the reference's weights across unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from ..core.dmm_torch import DeviceLike, resolve_device
from .attention import attention_decode, attention_train, attn_params, init_kv_cache
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, embed_params, lm_logits, mlp_params, norm_params
from .moe import moe_apply, moe_ffn, moe_params
from .ssm import (
    mamba_decode,
    mamba_init_state,
    mamba_params,
    mamba_train,
    rwkv_channel_mix,
    rwkv_channel_params,
    rwkv_decode,
    rwkv_init_state,
    rwkv_params,
    rwkv_train,
)

__all__ = [
    "init_params",
    "forward",
    "init_decode_state",
    "decode_step",
]

# The families a later slice ports, with the ROADMAP queue 1 item that does.
_UNPORTED = {
    "audio": "item 14.5 (audio family)",
    "vlm": "item 14.6 (vlm family)",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        where = _UNPORTED.get(cfg.family, "no item")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP queue 1 {where})"
        )


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _layer_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dev = gen.device
    if cfg.family == "ssm":
        return {
            "ln1": norm_params(cfg, dev),
            "tm": rwkv_params(gen, cfg),
            "ln2": norm_params(cfg, dev),
            "cm": rwkv_channel_params(gen, cfg),
        }
    p = {
        "norm1": norm_params(cfg, dev),
        "attn": attn_params(gen, cfg),
        "norm2": norm_params(cfg, dev),
    }
    if cfg.family == "hybrid":
        p["mamba"] = mamba_params(gen, cfg)
        p["mlp"] = mlp_params(gen, cfg)
    elif cfg.is_moe:
        p["moe"] = moe_params(gen, cfg)
    else:
        p["mlp"] = mlp_params(gen, cfg)
    return p


def init_params(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0, *,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random parameters for ``cfg`` on ``device`` (the card by default;
    raises when there is none).  ``generator`` is a :class:`torch.Generator`
    on that device, or an int that seeds a new one.  The draws come in a
    fixed order (embeddings, then each layer, then the final norm), so one
    seed on one device always gives the same parameters; they are not the
    reference's ``PRNGKey`` draws (use ``params_from_jax`` for those)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    return {
        "embed": embed_params(generator, cfg),
        "layers": [_layer_params(generator, cfg) for _ in range(cfg.n_layers)],
        "final_norm": norm_params(cfg, dev),
    }


def params_device(params: Dict[str, Any]) -> torch.device:
    """The device the parameters live on (that of the token embedding)."""
    return params["embed"]["tok"].device


# ---------------------------------------------------------------------------
# Forward (the serving prefill)
# ---------------------------------------------------------------------------


def _decoder_layer(lp: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer.  Returns (x, aux_loss): the MoE router's load-balance
    loss, a float32 zero for the other families."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h, _ = rwkv_train(lp["tm"], apply_norm(lp["ln1"], x, cfg), cfg, impl=cfg.rwkv_impl)
        x = x + h
        zero = torch.zeros((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
        cm, _ = rwkv_channel_mix(lp["cm"], apply_norm(lp["ln2"], x, cfg), zero, cfg)
        return x + cm, aux
    xn = apply_norm(lp["norm1"], x, cfg)
    attn_out = attention_train(lp["attn"], xn, positions, cfg, causal=True, window=cfg.window)
    if cfg.family == "hybrid":
        ssm_out, _ = mamba_train(lp["mamba"], xn, cfg)
        x = x + 0.5 * (attn_out + ssm_out)  # mean-fused parallel heads (Hymba)
    else:
        x = x + attn_out
    xn2 = apply_norm(lp["norm2"], x, cfg)
    if cfg.is_moe:
        ff, aux = moe_apply(lp["moe"], xn2, cfg)
    else:
        ff = apply_mlp(lp["mlp"], xn2, cfg)
    return x + ff, aux


def _embed_tokens(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"]["tok"][tokens.long()].to(cfg.cdtype)
    if cfg.pos == "learned":
        S = tokens.shape[1]
        x = x + params["embed"]["pos"][:S][None].to(cfg.cdtype)
    return x


def forward(params: Dict[str, Any], cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V_pad), aux_loss) for ``batch["tokens"]``
    (B, S) on the parameters' device.  ``aux_loss`` is the float32 sum of
    the layers' router load-balance losses, as the reference's layer scan
    sums them; a zero for the other families."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    auxs = []
    for lp in params["layers"]:
        x, aux = _decoder_layer(lp, x, positions, cfg)
        auxs.append(aux)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params["embed"], x, cfg)
    return logits, torch.sum(torch.stack(auxs))


# ---------------------------------------------------------------------------
# Decode (serving): single-token step against a cache
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Cache for one-token-at-a-time serving, on ``device`` (the card by
    default; raises when there is none).

    ``cache_len``: KV history length (the window size for sliding-window
    archs).  The ssm family carries O(1) state instead (``"rwkv"``: the wkv
    matrices in float32 and the two token-shift inputs), the hybrid family
    a rolling KV window beside the Mamba state (``"mamba"``: ``h`` and the
    conv tail, float32).  ``state["pos"]`` is a host int, one position for
    the whole batch, as in the reference."""
    _require_ported(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"pos": 0, "rwkv": rwkv_init_state(cfg, batch, L, dev)}
    kv_len = min(cache_len, cfg.window) if cfg.window else cache_len
    state = {"pos": 0, **init_kv_cache(cfg, batch, kv_len, L, dev)}
    if cfg.family == "hybrid":
        state["mamba"] = mamba_init_state(cfg, batch, L, dev)
    return state


def _rwkv_layer_step(lp: Dict[str, Any], x: torch.Tensor, st: Dict[str, torch.Tensor],
                     layer: int, cfg: ModelConfig) -> torch.Tensor:
    """One ssm layer of a decode step; the layer's state in ``st`` is
    overwritten with the next one (the normed inputs ``hn`` and ``hn2`` as
    the token shifts, as the reference stores them)."""
    hn = apply_norm(lp["ln1"], x, cfg)
    tm_out, ns = rwkv_decode(lp["tm"], hn, {"x_tm": st["x_tm"][layer], "wkv": st["wkv"][layer]},
                             cfg)
    x = x + tm_out
    hn2 = apply_norm(lp["ln2"], x, cfg)
    cm_out, x_cm = rwkv_channel_mix(lp["cm"], hn2, st["x_cm"][layer], cfg)
    st["wkv"][layer].copy_(ns["wkv"])
    st["x_tm"][layer].copy_(hn)
    st["x_cm"][layer].copy_(x_cm)
    return x + cm_out


def decode_step(params: Dict[str, Any], cfg: ModelConfig, state: Dict[str, Any],
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: consume ``token`` (B,), return (logits (B, V_pad),
    state').

    ``state'`` holds ``pos + 1`` and the SAME tensors as ``state``: the new
    K/V are written into the caches in place (see
    :func:`~repro_torch.models.attention.attention_decode`), and the ssm and
    Mamba states are overwritten with the next ones, so a state is not
    reusable after the step that consumed it."""
    _require_ported(cfg)
    pos = state["pos"]
    x = params["embed"]["tok"][token.long()[:, None]].to(cfg.cdtype)
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"][pos][None, None].to(cfg.cdtype)
    new_state = {**state, "pos": pos + 1}
    for layer, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            x = _rwkv_layer_step(lp, x, state["rwkv"], layer, cfg)
            continue
        hn = apply_norm(lp["norm1"], x, cfg)
        attn_out, _, _ = attention_decode(
            lp["attn"], hn, state["k"][layer], state["v"][layer], pos, cfg, window=cfg.window
        )
        if cfg.family == "hybrid":
            mh, mc = state["mamba"]["h"][layer], state["mamba"]["conv"][layer]
            ssm_out, ns = mamba_decode(lp["mamba"], hn, {"h": mh, "conv": mc}, cfg)
            x = x + 0.5 * (attn_out + ssm_out)
            mh.copy_(ns["h"])
            mc.copy_(ns["conv"])
        else:
            x = x + attn_out
        hn2 = apply_norm(lp["norm2"], x, cfg)
        x = x + (moe_ffn(lp["moe"], hn2, cfg) if cfg.is_moe else apply_mlp(lp["mlp"], hn2, cfg))
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params["embed"], x, cfg)[:, 0]
    return logits, new_state
