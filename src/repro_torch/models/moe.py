"""Mixture-of-Experts with DMM-style dispatch.

Counterpart of ``repro.models.moe``.  The MoE dispatch operator is the
paper's mapping matrix inside the model: a block-structured 0/1 operator
(tokens x expert-capacity slots) that is never materialised, only held as
compacted index sets.  ``cfg.moe_impl`` picks the algorithm:

  dense  -- scatter/gather dispatch per batch row ("group"): slot positions
            from a cumsum over the expert one-hot, tokens beyond an
            expert's capacity dropped.  The reference vmaps it over the
            batch; here the B groups' (E, C, D) buffers sit side by side
            along the slot axis, so each expert weight is read once a layer
            (one batched product per weight tensor), not once a group.
  dmm    -- the paper's Algorithm-6 analogue on a flat token axis: compacted
            index vectors (a stable argsort by expert) and masked gathers.
  ep     -- expert parallelism under the model mesh (``sh`` with a
            ``torch.distributed`` mesh): each rank routes its own tokens,
            ``all_to_all_single`` over the ``model`` group carries them to
            the ranks that own their experts and the results back.  Without
            a mesh ``ep`` takes the dense path, as the reference does.

Under the model mesh, ``moe_apply`` returns values equal to the
reference's GSPMD values on every rank, with this data rank's share of
their gradient (the shares summed over the data ranks are the reference's
gradient; :func:`repro_torch.sharding.comm.value_with_grad`):

  * dense and dmm run on the layer's input gathered over the data ranks, so
    ``dmm``'s capacity and every router aux loss see the whole token axis,
    and keep this rank's rows;
  * ep routes the rank's own tokens, capacity ``_capacity(T_loc)`` per
    (expert, source shard), as the reference's ``shard_map`` body.  Its aux
    loss is the value of shard (data 0, model 0) -- the reference's
    ``out_specs=P()`` of a per-shard scalar returns that shard's -- and its
    gradient is the mean of the data shards' aux losses, as the
    reference's ``shard_map`` transpose makes it.

Numerics follow the reference on purpose:

- the router's logits and softmax are IEEE float32 (TF32 is off for that
  product on the card, whatever the global setting);
- top-k keeps ``jax.lax.top_k``'s tie order, the lower expert id first
  (a stable descending sort; ``torch.topk`` promises no order on ties);
- capacity drops keep the earlier token (token-major positions);
- a dropped choice gathers its expert's slot C - 1 and multiplies it by 0;
- the combine sums each token's k weighted terms one after another in the
  compute dtype, in the reference's update order: top-k order for
  ``dense``, ascending expert id for ``dmm``.  ``index_add_`` on the card
  sums in no fixed order, so it is not used: two identical calls give
  identical bits.

The expert products are plain batched matrix products (``torch.bmm``), as
the reference leaves them to XLA; no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import spans
from ..sharding import comm
from .config import ModelConfig
from .layers import trunc_normal

__all__ = ["moe_params", "moe_apply", "moe_ffn", "router_aux_loss"]

Params = Dict[str, torch.Tensor]


def moe_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": trunc_normal(gen, (D, E), 1.0, torch.float32),  # router in f32
        "w_in": trunc_normal(gen, (E, D, F_), 1.0, cfg.pdtype),
        "w_gate": trunc_normal(gen, (E, D, F_), 1.0, cfg.pdtype),
        "w_out": trunc_normal(gen, (E, F_, D), 1.0, cfg.pdtype),
    }


def _ieee_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE float32: on the card TF32 is switched off for the
    call and restored after it."""
    if a.device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        return torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first and, among equal
    values, the lower index first (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (..., D) -> (gates (..., k) f32, experts (..., k) int64, probs (..., E) f32)."""
    logits = _ieee_matmul(x.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    return gates, experts, probs


def router_aux_loss(probs: torch.Tensor, experts: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss: E * <f_e * p_e>, a float32 scalar."""
    E = cfg.n_experts
    onehot = F.one_hot(experts.long(), E).to(torch.float32)  # (..., k, E)
    frac = torch.mean(torch.sum(onehot, dim=-2).reshape(-1, E), dim=0) / cfg.top_k
    mean_p = torch.mean(probs.reshape(-1, E), dim=0)
    return E * torch.sum(frac * mean_p)


def _expert_ffn(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h: (E, C, D) -> (E, C, D) through each expert's SwiGLU: three batched
    products over the expert axis, SiLU in float32 rounded to the compute
    dtype."""
    cd = cfg.cdtype
    a = torch.bmm(h, p["w_in"].to(cd))
    g = torch.bmm(h, p["w_gate"].to(cd))
    a = F.silu(g.to(torch.float32)).to(cd) * a
    return torch.bmm(a, p["w_out"].to(cd))


# ---------------------------------------------------------------------------
# dense: scatter/gather per batch-row group
# ---------------------------------------------------------------------------


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def _dispatch_indices(experts: torch.Tensor, E: int, C: int):
    """experts: (..., T, k) -> (slot, keep), each (..., T, k): the position
    of each choice within its expert, counted over the group's choices in
    token-major order, and whether it is within capacity.  Earlier tokens
    win (the paper's 'there cannot be two data containers at the same
    place')."""
    *lead, T, k = experts.shape
    flat = experts.reshape(*lead, T * k).long()
    # the reference's cumsum over a (T*k, E) one-hot, as ranks: a stable
    # sort by expert keeps token-major order within an expert, so a
    # choice's position within its expert is its index in the sorted list
    # less its expert's segment start
    order = torch.argsort(flat, dim=-1, stable=True)
    e_sorted = torch.gather(flat, -1, order)
    ids = torch.arange(E, device=flat.device).expand(*lead, E).contiguous()
    seg_start = torch.searchsorted(e_sorted, ids)
    ranks = torch.arange(T * k, device=flat.device) - torch.gather(seg_start, -1, e_sorted)
    slot = torch.empty_like(flat).scatter_(-1, order, ranks)
    keep = slot < C
    return slot.reshape(*lead, T, k), keep.reshape(*lead, T, k)


def _ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """terms: (..., k, D) -> (..., D): ``0 + t_0 + t_1 + ...``, each sum
    rounded to the terms' dtype, as the reference's scatter-add into zeros
    adds a token's updates one after another."""
    out = torch.zeros_like(terms[..., 0, :])
    for j in range(terms.shape[-2]):
        out += terms[..., j, :]
    return out


def _moe_groups(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The reference's ``jax.vmap(_moe_group)``: every batch row of x
    (B, T, D) is one group of T tokens with its own capacity C.  The B
    groups' buffers are laid side by side, (E, B*C, D), so one product per
    expert weight tensor serves them all.  Returns (out (B, T, D), probs,
    experts)."""
    B, T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    with spans.span("moe.route"):
        gates, experts, probs = _route(p, x, cfg)
    with spans.span("moe.dispatch"):
        spans.note("buffer_rows", E * B * C)
        slot, keep = _dispatch_indices(experts, E, C)
        # buffer row of (group b, expert e, slot s): (e*B + b)*C + s; a dropped
        # choice goes to one overflow row past the end, cut off
        b_idx = torch.arange(B, device=x.device)[:, None, None]
        row = (experts * B + b_idx) * C
        dst = torch.where(keep, row + slot, E * B * C).reshape(-1)
        src = x.to(cfg.cdtype).reshape(B * T, 1, D).expand(B * T, k, D).reshape(-1, D)
        buf = torch.zeros((E * B * C + 1, D), dtype=cfg.cdtype, device=x.device)
        buf[dst] = src  # every kept (e, s) is written once: a plain copy
    with spans.span("moe.experts"):
        out_e = _expert_ffn(p, buf[:-1].view(E, B * C, D), cfg).view(E * B * C, D)
    with spans.span("moe.combine"):
        # gather back; a dropped choice reads slot C - 1 and is multiplied by 0
        got = out_e[(row + torch.clamp(slot, max=C - 1)).reshape(-1)]
        got = got * (keep * gates).reshape(-1, 1).to(got.dtype)
        out = _ordered_sum(got.view(B, T, k, D))
    return out, probs, experts


# ---------------------------------------------------------------------------
# dmm: compacted index-set dispatch (Algorithm-6 analogue, flat token axis)
# ---------------------------------------------------------------------------


def _moe_dmm(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Sort-based dispatch: the mapping 'matrix' never exists, only its
    compacted index sets -- the choices sorted by expert id, segment starts
    from a search.  x (T, D) -> (out (T, D), probs, experts)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    dev = x.device
    gates, experts, probs = _route(p, x, cfg)
    flat_e = experts.reshape(-1)  # (T*k,)
    order = torch.argsort(flat_e, stable=True)  # compacted index set
    tok = torch.arange(T, device=dev).repeat_interleave(k)[order]
    e_sorted = flat_e[order]
    # position within expert segment
    seg_start = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - seg_start[e_sorted]
    keep = pos_in_e < C
    slot = e_sorted * C + torch.clamp(pos_in_e, max=C - 1)
    # gather the payload through the compacted set (the DMM apply)
    buf = torch.zeros((E * C + 1, D), dtype=cfg.cdtype, device=dev)
    buf[torch.where(keep, slot, E * C)] = x.to(cfg.cdtype)[tok]  # E*C: overflow row
    out_e = _expert_ffn(p, buf[:-1].view(E, C, D), cfg).view(E * C, D)
    got = out_e[slot] * keep[:, None]
    got = got * gates.reshape(-1)[order][:, None].to(got.dtype)
    # the reference adds the sorted list into zeros: a token's terms in
    # ascending expert id.  Term (t, j) of the token-major list sits at
    # sorted position inv[t*k + j]; a token's choices sorted by id name
    # its terms in that order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    by_id = torch.argsort(experts, dim=-1, stable=True)  # (T, k)
    at = inv[(torch.arange(T, device=dev)[:, None] * k + by_id).reshape(-1)]
    return _ordered_sum(got[at].view(T, k, D)), probs, experts


def _moe(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, D) -> (out (B, S, D), probs, experts) by ``cfg.moe_impl``."""
    B, S, D = x.shape
    if cfg.moe_impl == "dmm":
        out, probs, experts = _moe_dmm(p, x.reshape(-1, D), cfg)
        return out.reshape(B, S, D), probs, experts
    # dense, and ep without a mesh (the reference's fallback)
    return _moe_groups(p, x, cfg)


# ---------------------------------------------------------------------------
# ep: all-to-all expert parallelism over the model mesh's ``model`` axis
# ---------------------------------------------------------------------------


def _moe_ep_local(p_local: Params, x: torch.Tensor, cfg: ModelConfig, group):
    """One rank's share of expert parallelism.  x: (T_loc, D) this rank's
    tokens; ``p_local`` holds the full router and this rank's E_loc experts
    (experts split over ``group``, the model axis).  Returns (out (T_loc,
    D), probs, experts)."""
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_shards = comm.group_size(group)
    if E % n_shards:
        raise ValueError(f"ep: {E} experts do not split over a model axis of {n_shards}")
    E_loc = E // n_shards
    C = _capacity(T, cfg)  # capacity per (expert, source shard)
    cd = cfg.cdtype
    gates, experts, probs = _route(p_local, x, cfg)
    slot, keep = _dispatch_indices(experts, E, C)
    # (E, C + 1, D): a dropped choice goes to slot C, cut off
    dst = (experts * (C + 1) + torch.where(keep, slot, C)).reshape(-1)
    buf = torch.zeros((E * (C + 1), D), dtype=cd, device=x.device)
    buf[dst] = x.to(cd).reshape(T, 1, D).expand(T, k, D).reshape(-1, D)
    buf = buf.view(E, C + 1, D)[:, :C]
    # to the expert owners: (n_shards, E_loc, C, D), chunk j to model rank j
    recv = comm.all_to_all(buf.reshape(n_shards, E_loc, C, D), group)
    recv = recv.permute(1, 0, 2, 3).reshape(E_loc, n_shards * C, D)
    # every model rank of a data group sends the same tokens, so an owner's
    # weights get their gradient n_shards times: count it once
    ffn_p = {n: comm.scale_grad(p_local[n], 1.0 / n_shards) for n in ("w_in", "w_gate", "w_out")}
    out_e = _expert_ffn(ffn_p, recv, cfg)  # (E_loc, n_shards*C, D)
    send = out_e.view(E_loc, n_shards, C, D).permute(1, 0, 2, 3)
    back = comm.all_to_all(send.contiguous(), group).reshape(E * C, D)
    # my tokens' expert outputs; a dropped choice reads slot C - 1 times 0
    got = back[(experts * C + torch.clamp(slot, max=C - 1)).reshape(-1)]
    got = got * (keep * gates).reshape(-1, 1).to(got.dtype)
    return _ordered_sum(got.view(T, k, D)), probs, experts


def _moe_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig, sh):
    """``moe_apply`` under the model mesh (see the module docstring): x is
    this rank's (B_loc, S, D); ``p`` the gathered parameters (under ep the
    experts this rank owns)."""
    B, S, D = x.shape
    n_data = sh.data_size()
    data = sh.data_group()
    if cfg.moe_impl == "ep":
        out, probs, experts = _moe_ep_local(p, x.reshape(-1, D), cfg, sh.model_group())
        aux = router_aux_loss(probs, experts, cfg)
        first = comm.all_reduce_sum(aux if sh.data_index() == 0 else torch.zeros_like(aux), data)
        return out.reshape(B, S, D), comm.value_with_grad(first, aux / n_data)
    x_all = comm.all_gather_rows(x, data) if n_data > 1 else x
    out, probs, experts = _moe(p, x_all, cfg)
    aux = router_aux_loss(probs, experts, cfg)
    d = sh.data_index()
    return out[d * B:(d + 1) * B], comm.value_with_grad(aux, aux / n_data)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, sh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, D), aux_loss float32 scalar).  ``sh``: a sharding
    policy; under a ``torch.distributed`` mesh see the module docstring."""
    if sh is not None and sh.sharded:
        return _moe_sharded(p, x, cfg, sh)
    out, probs, experts = _moe(p, x, cfg)
    return out, router_aux_loss(probs, experts, cfg)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`moe_apply`'s output alone, for decode, which discards the
    auxiliary loss (the reference computes it and drops it)."""
    with spans.span("moe"):
        spans.note("tokens", x.numel() // x.shape[-1])
        return _moe(p, x, cfg)[0]
