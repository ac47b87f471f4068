"""The model zoo's six families: one functional model over plain
parameter dicts.

Counterpart of ``repro.models.model`` for every family of ``configs``:
``"dense"`` (olmo-1b, llama3-405b, phi3-medium-14b, stablelm-1.6b; sliding
windows included), ``"moe"`` (qwen3-moe-30b-a3b, dbrx-132b: the FFN is
:func:`repro_torch.models.moe.moe_apply`), ``"ssm"`` (rwkv6-3b: RWKV-6 time
and channel mix, :mod:`repro_torch.models.ssm`), ``"hybrid"`` (hymba-1.5b:
windowed attention and Mamba heads in parallel, mean-fused), ``"audio"``
(whisper-tiny: a non-causal encoder over stubbed conv-frontend frames, and
decoder layers that cross-attend its output) and ``"vlm"`` (internvl2-1b:
stubbed ViT patch embeddings prefix the text, causal over both).  The
reference scans stacked layers with ``lax.scan``; here ``params["layers"]``
(and ``params["enc_layers"]``) is a list of per-layer dicts and the layers
run in a Python loop.  ``cfg.remat`` wraps each layer of that loop in
``torch.utils.checkpoint`` when autograd records the parameters (see
:func:`_remat`); ``scan_unroll`` and ``dryrun_n_micro`` steer XLA and
have no counterpart.

``forward`` and ``loss_fn`` take the reference's ``sh``, a sharding policy
(:mod:`repro_torch.sharding.specs`).  Under a ``torch.distributed`` mesh
the parameters are DTensors stored as the reference shards them, each rank
holds its data rank's batch rows, and compute splits over ``model`` as the
reference's activation constraints split it: each layer gathers its
weights over the data axes inside the function that remat checkpoints
(:meth:`~repro_torch.sharding.specs.ShardingPolicy.gather_layer`, so the
recompute gathers again in the backward and no layer's gathered weights
live from forward to backward), attention runs on the rank's query heads
and the MLP on its slice of the hidden, the embedding, head and loss on
its slice of the vocabulary, and the MoE layer sees the whole token axis
(or runs expert parallelism under ``ep``).  ``loss_fn`` returns the whole
batch's loss on every rank with this data rank's share of its gradient.
``sp_carry`` (the reference shards the saved residual stack over
``model``) has nothing to shard here and is ignored.

Entry points: ``init_params``, ``forward`` (logits; the serving prefill
and the training forward), ``loss_fn`` (the training loss),
``init_decode_state`` / ``prefill_memory`` (whisper: the encoder's K/V
into the cache) / ``decode_step`` (single-token serving).  Parameters keep
the reference's layout, so :func:`repro_torch.core.convert.params_from_jax`
carries the reference's weights across unchanged.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .. import spans
from ..core.dmm_torch import DeviceLike, resolve_device
from ..core.tree import tree_leaves, tree_map
from ..sharding import comm
from ..sharding.specs import decode_state_specs, local_shape
from .attention import (
    attention_decode,
    attention_train,
    attn_params,
    cross_attention,
    init_kv_cache,
    project_memory,
)
from .config import ModelConfig
from .layers import (
    apply_mlp,
    apply_norm,
    cross_entropy,
    cross_entropy_sums,
    embed_params,
    lm_logits,
    mlp_params,
    norm_params,
    split_group,
    trunc_normal,
    vocab_start,
)
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
    "AUX_WEIGHT",
    "init_params",
    "forward",
    "loss_fn",
    "init_decode_state",
    "prefill_memory",
    "decode_step",
]


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
    if cfg.enc_dec:  # the decoder layer gains cross-attention
        p["norm_x"] = norm_params(cfg, dev)
        p["xattn"] = attn_params(gen, cfg)
    return p


def _enc_layer_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dev = gen.device
    return {
        "norm1": norm_params(cfg, dev),
        "attn": attn_params(gen, cfg),
        "norm2": norm_params(cfg, dev),
        "mlp": mlp_params(gen, cfg),
    }


class _ShapesOnly:
    """The generator of a parameter tree on the ``meta`` device, which has
    none: it carries the device, and ``trunc_normal`` draws nothing there."""

    def __init__(self, device: torch.device):
        self.device = device


def init_params(cfg: ModelConfig, generator: Union[torch.Generator, int] = 0, *,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random parameters for ``cfg`` on ``device`` (the card by default;
    raises when there is none).  ``generator`` is a :class:`torch.Generator`
    on that device, or an int that seeds a new one.  The draws come in a
    fixed order (embeddings, then each layer, then the final norm; for an
    encoder-decoder then each encoder layer and the encoder positions), so
    one seed on one device always gives the same parameters; they are not
    the reference's ``PRNGKey`` draws (use ``params_from_jax`` for
    those).  On ``device="meta"`` the tree has the shapes and dtypes alone
    and ``generator`` is not used (the dry run)."""
    dev = resolve_device(device)
    if dev.type == "meta":  # shapes alone (the dry run): no generator, no draws
        generator = _ShapesOnly(dev)
    elif isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    params = {
        "embed": embed_params(generator, cfg),
        "layers": [_layer_params(generator, cfg) for _ in range(cfg.n_layers)],
        "final_norm": norm_params(cfg, dev),
    }
    if cfg.enc_dec:
        params["enc_layers"] = [_enc_layer_params(generator, cfg)
                                for _ in range(cfg.enc_layers)]
        params["enc_final_norm"] = norm_params(cfg, dev)
        params["enc_pos"] = trunc_normal(generator, (cfg.enc_seq, cfg.d_model), 1.0, cfg.pdtype)
    return params


def params_device(params: Dict[str, Any]) -> torch.device:
    """The device the parameters live on (that of the token embedding)."""
    return params["embed"]["tok"].device


# ---------------------------------------------------------------------------
# Forward (the serving prefill)
# ---------------------------------------------------------------------------


def _decoder_layer(lp: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, memory: Optional[torch.Tensor] = None, sh=None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer.  Returns (x, aux_loss): the MoE router's load-balance
    loss, a float32 zero for the other families.  ``memory``: the raw
    encoder output of an encoder-decoder, which the layer projects with its
    own cross-attention weights.  Under a mesh (``sh``) ``lp`` holds the
    stored shards, gathered here (:func:`_gather_layer`)."""
    lp = _gather_layer(lp, cfg, sh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h, _ = rwkv_train(lp["tm"], apply_norm(lp["ln1"], x, cfg), cfg, impl=cfg.rwkv_impl,
                          sh=sh)
        x = x + h
        zero = torch.zeros((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
        cm, _ = rwkv_channel_mix(lp["cm"], apply_norm(lp["ln2"], x, cfg), zero, cfg, sh)
        return x + cm, aux
    xn = apply_norm(lp["norm1"], x, cfg)
    attn_out = attention_train(lp["attn"], xn, positions, cfg, causal=True, window=cfg.window,
                               sh=sh)
    if cfg.family == "hybrid":
        ssm_out, _ = mamba_train(lp["mamba"], xn, cfg, sh=sh)
        x = x + 0.5 * (attn_out + ssm_out)  # mean-fused parallel heads (Hymba)
    else:
        x = x + attn_out
    if memory is not None:
        mem_k, mem_v = project_memory(lp["xattn"], memory, cfg, sh)
        x = x + cross_attention(lp["xattn"], apply_norm(lp["norm_x"], x, cfg), mem_k, mem_v, cfg,
                                sh)
    xn2 = apply_norm(lp["norm2"], x, cfg)
    if cfg.is_moe:
        ff, aux = moe_apply(lp["moe"], xn2, cfg, sh=sh)
    else:
        ff = apply_mlp(lp["mlp"], xn2, cfg, sh=sh)
    x = x + ff
    if sh is not None:
        x = sh.act_btd(x)
    return x, aux


def _enc_layer(lp: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, sh=None) -> torch.Tensor:
    """One pre-norm encoder layer: non-causal self-attention, then the MLP
    (``lp`` gathered here under a mesh, as in :func:`_decoder_layer`)."""
    lp = _gather_layer(lp, cfg, sh)
    hn = apply_norm(lp["norm1"], x, cfg)
    x = x + attention_train(lp["attn"], hn, positions, cfg, causal=False, sh=sh)
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg, sh=sh)


# the products that remat "dots" keeps (JAX's checkpoint_dots_with_no_batch_dims):
# 2-D matrix products; batched ones (bmm) are recomputed like the rest
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` (one layer) under ``cfg.remat``, the reference's ``_remat``:
    ``"none"`` keeps every activation, ``"full"`` keeps only the layer's
    inputs and recomputes the rest in the backward pass, ``"dots"`` keeps
    the outputs of the 2-D matrix products (``aten.mm`` / ``aten.addmm``)
    and recomputes the rest, batched products included.  Non-reentrant
    ``torch.utils.checkpoint``; recomputation repeats the same operations,
    so loss and gradients are the same bits under all three.

    The reference's ``_scan_layers`` and ``_carry_barrier`` have no
    counterpart: they are XLA's layer scan and a fusion fence that keeps
    the scan's saved carry in the compute dtype; here the layers are a
    Python loop and a checkpoint saves the layer's input as it is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        dots = functools.partial(create_selective_checkpoint_contexts, _save_products)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=dots)
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: expected 'none', 'full' or 'dots'")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _layer_fn(fn: Callable, params: Dict[str, Any], cfg: ModelConfig) -> Callable:
    """``fn`` under remat when autograd records the parameters (grad mode
    on and a parameter requiring grad); as it is otherwise, so serving runs
    the layers directly."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tree_leaves(params)):
        return _remat(fn, cfg)
    return fn


def _gather(tree: Any, sh) -> Any:
    """``tree`` with its DTensor leaves gathered (under a mesh), else as it is."""
    return sh.gather(tree) if sh is not None and sh.sharded else tree


def _gather_layer(lp: Dict[str, Any], cfg: ModelConfig, sh,
                  caches: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """One layer's weights for its compute on this rank (under a mesh, by
    :meth:`~repro_torch.sharding.specs.ShardingPolicy.gather_layer`: the
    split leaves keep their ``model`` slices, under expert parallelism each
    rank its own experts, the rest whole; ``caches``: decode's cache
    splits); as they are otherwise."""
    if sh is None or not sh.sharded:
        return lp
    return sh.gather_layer(lp, cfg, caches)


def _gather_embed(embed: Dict[str, Any], cfg: ModelConfig, sh) -> Dict[str, Any]:
    """The embedding and head: under a mesh gathered over the data axes,
    and where the vocabulary splits over ``model``,
    ``tok``'s rows and ``head``'s columns keep this rank's slice."""
    if sh is None or not sh.sharded:
        return embed
    if split_group(sh, cfg, "vocab") is None:
        return sh.gather(embed)
    dims = {"tok": 0, "head": 1}  # (V/M, D) rows, (D, V/M) columns
    return {k: sh.gather_split(v, dims[k], k) if k in dims else sh.gather(v)
            for k, v in embed.items()}


def _embed_tokens(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
                  sh=None) -> torch.Tensor:
    """The token rows, then (learned positions, the encoder-decoder's
    included) the position rows, each cast to the compute dtype: the
    reference's order, which adds the encoder-decoder's in ``forward``.
    Where ``sh`` splits the vocabulary, ``tok`` is this rank's rows and the
    lookup is :func:`~repro_torch.sharding.comm.vocab_lookup`."""
    tok = params["embed"]["tok"]
    group = split_group(sh, cfg, "vocab")
    x = tok[tokens.long()] if group is None else comm.vocab_lookup(tok, tokens,
                                                                    vocab_start(cfg, sh), group)
    x = x.to(cfg.cdtype)
    if cfg.pos == "learned":
        S = tokens.shape[1]
        x = x + params["embed"]["pos"][:S][None].to(cfg.cdtype)
    return x


def _encode(params: Dict[str, Any], frames: torch.Tensor, cfg: ModelConfig, sh=None
            ) -> torch.Tensor:
    """The whisper encoder over stubbed conv-frontend frames (B, enc_seq,
    D): learned positions, pre-norm layers of non-causal self-attention
    (``flash_attention`` with ``attn_impl="pallas"``) and the MLP, then
    the final norm."""
    x = frames.to(cfg.cdtype) + _gather(params["enc_pos"], sh)[None].to(cfg.cdtype)
    positions = torch.arange(frames.shape[1], device=x.device)[None]
    layer = _layer_fn(_enc_layer, params, cfg)
    for lp in params["enc_layers"]:
        x = layer(lp, x, positions, cfg, sh)
    return apply_norm(_gather(params["enc_final_norm"], sh), x, cfg)


def _forward(params: Dict[str, Any], cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             sh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`forward`, with this rank's vocabulary columns of the logits
    where ``sh`` splits the vocabulary."""
    tokens = batch["tokens"]
    embed = _gather_embed(params["embed"], cfg, sh)
    x = _embed_tokens({"embed": embed}, tokens, cfg, sh)
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(cfg.cdtype), x], dim=1)
    if sh is not None:
        x = sh.act_btd(x)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    memory = _encode(params, batch["frames"], cfg, sh) if cfg.enc_dec else None
    layer = _layer_fn(_decoder_layer, params, cfg)
    auxs = []
    for lp in params["layers"]:
        x, aux = layer(lp, x, positions, cfg, memory, sh)
        auxs.append(aux)
    x = apply_norm(_gather(params["final_norm"], sh), x, cfg)
    logits = lm_logits(embed, x, cfg, sh)
    if sh is not None:
        logits = sh.logits(logits)
    return logits, torch.sum(torch.stack(auxs))


def forward(params: Dict[str, Any], cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            sh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V_pad), aux_loss) for ``batch["tokens"]``
    (B, S) on the parameters' device.  ``aux_loss`` is the float32 sum of
    the layers' router load-balance losses, as the reference's layer scan
    sums them; a zero for the other families.

    An encoder-decoder also takes ``batch["frames"]`` (B, enc_seq, D); the
    vlm family ``batch["patches"]`` (B, P, D), cast to the compute dtype
    and put before the text, so the logits are (B, P + S, V_pad) with the
    patch positions kept, as in the reference.

    ``sh``: a sharding policy; under a mesh ``batch`` holds this data
    rank's rows (see the module docstring), and the vocabulary shards of
    the logits are joined over ``model`` (one all-gather)."""
    logits, aux = _forward(params, cfg, batch, sh)
    group = split_group(sh, cfg, "vocab")
    return (logits if group is None else comm.all_gather_cols(logits, group)), aux


AUX_WEIGHT = 0.01


def loss_fn(params: Dict[str, Any], cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            sh=None) -> torch.Tensor:
    """The training loss, a float32 scalar: the mean token cross-entropy of
    ``forward``'s logits against ``batch["labels"]`` (weighted by
    ``batch["loss_weight"]`` when present), plus ``AUX_WEIGHT`` times the
    routers' load-balance loss.  The vlm family's logits drop the patch
    prefix first, so the labels cover the text alone.

    Under a mesh (``sh``), ``batch`` is this data rank's rows and the loss
    is the whole batch's, on every rank: ``sum(nll * w)`` and ``sum(w)``
    are each summed over the data ranks before the division (METL batches
    weight their tokens unevenly).  Its gradient is this rank's share: the
    rank's ``sum(nll * w)`` over the global ``sum(w)``, plus its share of
    the aux loss, so that the data ranks' gradients sum to the whole
    batch's."""
    logits, aux = _forward(params, cfg, batch, sh)
    if cfg.family == "vlm":
        logits = logits[:, batch["patches"].shape[1]:]
    if sh is None or not sh.sharded:
        loss = cross_entropy(logits, batch["labels"], cfg, batch.get("loss_weight"))
        return loss + AUX_WEIGHT * aux
    nll_w, w = cross_entropy_sums(logits, batch["labels"], cfg, batch.get("loss_weight"), sh)
    totals = comm.all_reduce_sum(torch.stack([nll_w.detach(), w]), sh.data_group())
    denom = torch.clamp(totals[1], min=1.0) if "loss_weight" in batch else totals[1]
    ce = comm.value_with_grad(totals[0] / denom, nll_w / denom)
    return ce + AUX_WEIGHT * aux


# ---------------------------------------------------------------------------
# Decode (serving): single-token step against a cache
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device: DeviceLike = "cuda", sh=None) -> Dict[str, Any]:
    """Cache for one-token-at-a-time serving, on ``device`` (the card by
    default; raises when there is none).

    ``cache_len``: KV history length (the window size for sliding-window
    archs).  The ssm family carries O(1) state instead (``"rwkv"``: the wkv
    matrices in float32 and the two token-shift inputs), the hybrid family
    a rolling KV window beside the Mamba state (``"mamba"``: ``h`` and the
    conv tail, float32).  ``state["pos"]`` is a host int, one position for
    the whole batch, as in the reference.  An encoder-decoder's cache also
    holds the cross-attention memory ``"xk"`` / ``"xv"`` (L, B, enc_seq,
    KV, hd), zeros until :func:`prefill_memory` writes them.

    ``sh``: a sharding policy; under a mesh the state is this rank's shard
    of the whole one, each leaf as :func:`~repro_torch.sharding.specs.
    decode_state_specs` places it (this data rank's rows, and over
    ``model`` its KV heads or time slots, ``wkv`` heads or Mamba
    channels), and each KV cache carries its split (``cache_split``, the
    rule of :meth:`~repro_torch.sharding.specs.TensorSplit.kv_cache`) for
    :func:`decode_step`."""
    dev = resolve_device(device)
    if sh is not None and sh.sharded:
        whole = init_decode_state(cfg, batch, cache_len, device="meta")
        specs = decode_state_specs(cfg, sh, whole)
        state = tree_map(lambda t, s: t if isinstance(t, int) else torch.zeros(
            local_shape(t.shape, s, sh), dtype=t.dtype, device=dev), whole, specs)
        ts = sh.tensor_split(cfg)
        for name in ("k", "xk"):
            if name in state:
                state[name].cache_split = "whole" if ts is None else ts.kv_cache(
                    whole[name].shape[2])
        return state
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"pos": 0, "rwkv": rwkv_init_state(cfg, batch, L, dev)}
    kv_len = min(cache_len, cfg.window) if cfg.window else cache_len
    state = {"pos": 0, **init_kv_cache(cfg, batch, kv_len, L, dev)}
    if cfg.family == "hybrid":
        state["mamba"] = mamba_init_state(cfg, batch, L, dev)
    if cfg.enc_dec:
        memory = init_kv_cache(cfg, batch, cfg.enc_seq, L, dev)
        state["xk"], state["xv"] = memory["k"], memory["v"]
    return state


def _cache_splits(state: Dict[str, Any], cfg: ModelConfig, sh) -> Optional[Dict[str, str]]:
    """How the state's KV caches split over ``model`` under ``sh`` (the
    marks :func:`init_decode_state` leaves): ``{"attn": ..., "xattn":
    ...}``, or None off a tensor split.  A state that holds no mark raises:
    it was not made for this mesh."""
    if sh is None or sh.tensor_split(cfg) is None or "k" not in state:
        return None
    out = {}
    for block, name in (("attn", "k"), ("xattn", "xk")):
        if name in state:
            split = getattr(state[name], "cache_split", None)
            if split is None:
                raise ValueError("decode over a model split needs a state from "
                                 "init_decode_state(..., sh=sh)")
            out[block] = split
    return out


def prefill_memory(params: Dict[str, Any], cfg: ModelConfig, frames: torch.Tensor,
                   state: Dict[str, Any], sh=None) -> Dict[str, Any]:
    """Whisper: run the encoder once over ``frames`` (B, enc_seq, D) and
    write each decoder layer's projected cross K/V into ``state["xk"]`` /
    ``["xv"]`` IN PLACE (the reference returns new arrays); returns the
    state.  Under a mesh (``sh``), ``frames`` are this data rank's rows and
    the state this rank's (:func:`init_decode_state` with the same ``sh``):
    the memory is projected for this rank's KV heads, or its time slots,
    as the cache splits."""
    if sh is not None and not sh.sharded:
        sh = None
    splits = _cache_splits(state, cfg, sh)
    mode = splits["xattn"] if splits else "whole"
    with torch.no_grad():
        enc = _encode(params, frames, cfg, sh)
        if mode == "time":
            enc = enc[:, sh.tensor_split(cfg).part(cfg.enc_seq)]
        for layer, lp in enumerate(params["layers"]):
            xattn = _gather_layer({"xattn": lp["xattn"]}, cfg, sh, splits)["xattn"]
            k, v = project_memory(xattn, enc, cfg, sh if mode == "heads" else None)
            if k.shape != state["xk"][layer].shape:
                raise ValueError(f"memory K/V {tuple(k.shape)} do not fit the cache's "
                                 f"{tuple(state['xk'][layer].shape)}")
            state["xk"][layer].copy_(k)
            state["xv"][layer].copy_(v)
    return state


def _rwkv_layer_step(lp: Dict[str, Any], x: torch.Tensor, st: Dict[str, torch.Tensor],
                     layer: int, cfg: ModelConfig, sh=None) -> torch.Tensor:
    """One ssm layer of a decode step; the layer's state in ``st`` is
    overwritten with the next one (the normed inputs ``hn`` and ``hn2`` as
    the token shifts, as the reference stores them)."""
    hn = apply_norm(lp["ln1"], x, cfg)
    tm_out, ns = rwkv_decode(lp["tm"], hn, {"x_tm": st["x_tm"][layer], "wkv": st["wkv"][layer]},
                             cfg, sh)
    x = x + tm_out
    hn2 = apply_norm(lp["ln2"], x, cfg)
    cm_out, x_cm = rwkv_channel_mix(lp["cm"], hn2, st["x_cm"][layer], cfg, sh)
    st["wkv"][layer].copy_(ns["wkv"])
    st["x_tm"][layer].copy_(hn)
    st["x_cm"][layer].copy_(x_cm)
    return x + cm_out


def _decode_step(params: Dict[str, Any], cfg: ModelConfig, state: Dict[str, Any],
                 token: torch.Tensor, sh=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """:func:`decode_step`, with this rank's vocabulary columns of the
    logits where ``sh`` splits the vocabulary."""
    if sh is not None and not sh.sharded:
        sh = None
    splits = _cache_splits(state, cfg, sh)
    with spans.span("model.decode"):
        spans.note("layers", len(params["layers"]))
        pos = state["pos"]
        embed = _gather_embed(params["embed"], cfg, sh)
        group = split_group(sh, cfg, "vocab")
        tok = embed["tok"]
        x = (tok[token.long()[:, None]] if group is None
             else comm.vocab_lookup(tok, token[:, None], vocab_start(cfg, sh), group)
             ).to(cfg.cdtype)
        if cfg.pos == "learned":
            x = x + embed["pos"][pos][None, None].to(cfg.cdtype)
        new_state = {**state, "pos": pos + 1}
        for layer, lp in enumerate(params["layers"]):
            if cfg.enc_dec:  # the memory cache stands for the cross K/V projections
                lp = {**lp, "xattn": {k: lp["xattn"][k] for k in ("wq", "wo")}}
            lp = _gather_layer(lp, cfg, sh, splits)
            if cfg.family == "ssm":
                x = _rwkv_layer_step(lp, x, state["rwkv"], layer, cfg, sh)
                continue
            hn = apply_norm(lp["norm1"], x, cfg)
            attn_out, _, _ = attention_decode(
                lp["attn"], hn, state["k"][layer], state["v"][layer], pos, cfg,
                window=cfg.window, sh=sh, kv_split=splits and splits["attn"])
            if cfg.family == "hybrid":
                mh, mc = state["mamba"]["h"][layer], state["mamba"]["conv"][layer]
                ssm_out, ns = mamba_decode(lp["mamba"], hn, {"h": mh, "conv": mc}, cfg, sh)
                x = x + 0.5 * (attn_out + ssm_out)
                mh.copy_(ns["h"])
                mc.copy_(ns["conv"])
            else:
                x = x + attn_out
            if cfg.enc_dec:
                x = x + cross_attention(lp["xattn"], apply_norm(lp["norm_x"], x, cfg),
                                        state["xk"][layer], state["xv"][layer], cfg, sh,
                                        kv_split=splits and splits["xattn"])
            hn2 = apply_norm(lp["norm2"], x, cfg)
            if cfg.is_moe:
                ff = (moe_ffn(lp["moe"], hn2, cfg) if sh is None
                      else moe_apply(lp["moe"], hn2, cfg, sh=sh)[0])
            else:
                with spans.span("mlp"):
                    ff = apply_mlp(lp["mlp"], hn2, cfg, sh=sh)
            x = x + ff
        with spans.span("model.head"):
            x = apply_norm(_gather(params["final_norm"], sh), x, cfg)
            logits = lm_logits(embed, x, cfg, sh)[:, 0]
    return logits, new_state


def decode_step(params: Dict[str, Any], cfg: ModelConfig, state: Dict[str, Any],
                token: torch.Tensor, sh=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: consume ``token`` (B,), return (logits (B, V_pad),
    state').

    ``state'`` holds ``pos + 1`` and the SAME tensors as ``state``: the new
    K/V are written into the caches in place (see
    :func:`~repro_torch.models.attention.attention_decode`), and the ssm and
    Mamba states are overwritten with the next ones, so a state is not
    reusable after the step that consumed it.  An encoder-decoder's layers
    cross-attend ``state["xk"]`` / ``["xv"]``, which carry over unchanged.

    ``sh``: a sharding policy.  Under a mesh ``token`` holds this data
    rank's rows and ``state`` is this rank's (:func:`init_decode_state`
    with the same ``sh``); each layer's weights are gathered for this
    rank's split (:meth:`~repro_torch.sharding.specs.ShardingPolicy.
    gather_layer`, with the caches' splits), no gradient is recorded, and
    the vocabulary shards of the logits are joined over ``model`` (one
    all-gather; the serving step's argmax reads the shards instead,
    :func:`repro_torch.serve.decode.make_serve_step`)."""
    if sh is None or not sh.sharded:
        return _decode_step(params, cfg, state, token)
    with torch.no_grad():
        logits, state = _decode_step(params, cfg, state, token, sh)
        group = split_group(sh, cfg, "vocab")
        return (logits if group is None else comm.all_gather_cols(logits, group)), state
