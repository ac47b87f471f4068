"""Plain PyTorch versions of the port's CUDA kernels.

They are written as the reference's pure-jnp oracles
(``repro.kernels.ref`` and ``repro.kernels.ops._resolve_items``) write
them: the same gathers, the same unrolled select for :func:`densify_map_ref`
and ``torch.clamp`` where the reference clips.  The kernel wrappers run them
for tensors on the CPU; ``chip_smoke.py`` holds the kernels against them on
the card.  Nothing on the main path calls them when a card is present.

The mapping functions but :func:`onehot_map_ref` only select (no
arithmetic on values), so a kernel and its plain version agree bit for bit.
:func:`onehot_map_ref` contracts through a 0/1 matrix in IEEE float32 (a
multiply and a sum, never a matrix unit that a TF32 setting could reach);
its kernel sums in another order, so values agree within ``atol=1e-5`` and
masks bit for bit.  The model kernels' plain versions,
:func:`attention_ref`, :func:`decode_attention_ref` and
:func:`moe_combine_ref`, compute in float32 and
round once to the output dtype; their kernels sum in another order, so they
are held to the tolerances of the reference's own kernel tests.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = [
    "masked_gather_ref",
    "onehot_map_ref",
    "segmented_gather_ref",
    "segmented_gather_shard_ref",
    "densify_map_ref",
    "resolve_items_ref",
    "route_offset",
    "densify_map_packed_ref",
    "densify_map_shard_ref",
    "attention_ref",
    "decode_attention_ref",
    "moe_combine_ref",
]

NEG_INF = -1e30  # the masked score of attention_ref, as the reference's oracle


def masked_gather_ref(
    values: torch.Tensor,
    mask: torch.Tensor,
    src: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DMM mapping of one block.

    values: (B, N_in) payload (float32 or bfloat16), mask: (B, N_in)
    validity (bool or int8), src: (N_out,) int32 with -1 for filtered/null
    output slots.  Returns (out_values (B, N_out) in ``values.dtype``,
    out_mask (B, N_out) int8).
    """
    mask = mask != 0
    valid = src >= 0
    safe = torch.where(valid, src, 0).long()
    out_v = values.index_select(1, safe)
    out_m = mask.index_select(1, safe) & valid[None, :]
    out_v = torch.where(out_m, out_v, fill)
    return out_v, out_m.to(torch.int8)


def onehot_map_ref(
    values: torch.Tensor,
    mask: torch.Tensor,
    src: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baseline (the paper's Algorithm-1 world): the block applied as an
    explicit 0/1 matrix, ``out = vals @ M.T`` and ``mask @ M.T > 0.5``, in
    float32 whatever ``values.dtype``; ``fill`` where the mask is unset.

    The contraction is written as a float32 multiply and sum over the true
    N_in, so it does not depend on ``torch.backends.cuda.matmul.allow_tf32``
    and a non-finite value anywhere in an event row reaches every output of
    that row, as it does through a matrix unit.  Same shapes as
    :func:`masked_gather_ref`.
    """
    n_in = values.shape[1]
    cols = torch.arange(n_in, dtype=src.dtype, device=src.device)
    m = (src[:, None] == cols[None, :]).to(torch.float32)  # (N_out, N_in)
    out_v = (values.to(torch.float32)[:, None, :] * m[None]).sum(-1)
    out_m = (mask.to(torch.float32)[:, None, :] * m[None]).sum(-1) > 0.5
    out_v = torch.where(out_m, out_v, fill)
    return out_v.to(values.dtype), out_m.to(torch.int8)


def segmented_gather_ref(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src2d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused DMM mapping (whole chunk, all blocks, one pass).

    values: (B, N_in) payload, mask: (B, N_in) validity, rows/blks: (S,)
    int32 routing (output row s = event rows[s] through block blks[s]),
    src2d: (n_blocks_pad, W) int32 block index vectors (-1 = null).
    Returns (out_values (S, W), out_mask (S, W) int8).
    """
    mask = mask != 0
    src = src2d.index_select(0, blks.long())  # (S, W)
    valid = src >= 0
    safe = torch.where(valid, src, 0).long()
    v_rows = values.index_select(0, rows.long())  # (S, N_in)
    m_rows = mask.index_select(0, rows.long())
    out_v = torch.gather(v_rows, 1, safe)
    out_m = torch.gather(m_rows, 1, safe) & valid
    out_v = torch.where(out_m, out_v, fill)
    return out_v, out_m.to(torch.int8)


def segmented_gather_shard_ref(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src3d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sharded fused mapping, shard by shard: shard ``z`` maps its
    routing ``rows[z]`` / ``blks[z]`` (n_shards, S_loc) through its own
    table slice ``src3d[z]`` with :func:`segmented_gather_ref`, over the
    shared payload.  Returns (out_values (n_shards, S_loc, W), out_mask
    (n_shards, S_loc, W) int8)."""
    outs = [segmented_gather_ref(values, mask, r, b, t, fill=fill)
            for r, b, t in zip(rows, blks, src3d)]
    return _stack_shards(outs, rows.shape[1], src3d.shape[2], values.dtype, values.device)


def _stack_shards(outs, s, w, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (values, mask) pairs stacked on a leading shard axis."""
    if not outs:
        return (torch.empty((0, s, w), dtype=dtype, device=device),
                torch.empty((0, s, w), dtype=torch.int8, device=device))
    return torch.stack([v for v, _ in outs]), torch.stack([m for _, m in outs])


def densify_map_ref(
    slot2d: torch.Tensor,
    x2d: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src2d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-densify + fused mapping, scatter-free.

    slot2d: (B, K) int32 payload slot per item of event row b (-1 =
    dropped), x2d: (B, K) values, rows/blks: (S,) int32 routing, src2d:
    (n_blocks_pad, W) int32.  Output (s, q) takes the value of the LAST item
    j (ascending) of event ``rows[s]`` whose slot equals ``src2d[blks[s],
    q]`` -- the host scatter's last-writer-wins -- through an unrolled
    select, never a scatter (``index_put_`` with duplicate indices has no
    defined winner on CUDA).  Returns (out_values (S, W), out_mask (S, W)
    int8).
    """
    k = slot2d.shape[1]
    src = src2d.index_select(0, blks.long())  # (S, W)
    valid = src >= 0
    es = slot2d.index_select(0, rows.long())  # (S, K)
    ex = x2d.index_select(0, rows.long())  # (S, K)
    acc = torch.full(src.shape, fill, dtype=x2d.dtype, device=x2d.device)
    hit = torch.zeros(src.shape, dtype=torch.bool, device=x2d.device)
    for j in range(k):  # K = items/event, small: unrolled selects
        m = valid & (src == es[:, j : j + 1])
        acc = torch.where(m, ex[:, j : j + 1], acc)
        hit = hit | m
    return acc, hit.to(torch.int8)


def resolve_items_ref(
    packed: torch.Tensor,
    uid_slot: torch.Tensor,
    uid_col: torch.Tensor,
    *,
    n_items: int,
    n_events: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack the item columns of a packed chunk and resolve them against
    the plan's uid tables.

    ``packed`` is ``[uids(NI) | val_bits(NI) | starts(B) | counts(B) |
    ev_col(B) | rows | blks]`` (int32; values travel as bit patterns).
    Returns ``(slot2d, x2d)``, each (B, K): per event, its first K items as
    (payload slot | -1 dropped, value).  An item is dropped when it is CSR
    padding (``kk >= counts``), its uid is outside ``[0, len(uid_slot))``,
    its slot is -1, or its owning column is not the event's.
    """
    ni, b = n_items, n_events
    uids = packed[:ni]
    vals = packed[ni : 2 * ni].view(torch.float32)
    o = 2 * ni
    starts = packed[o : o + b]
    counts = packed[o + b : o + 2 * b]
    ev_col = packed[o + 2 * b : o + 3 * b]
    kk = torch.arange(k, dtype=torch.int32, device=packed.device)
    item_valid = kk[None, :] < counts[:, None]  # (b, k)
    ix = torch.where(item_valid, starts[:, None] + kk[None, :], 0)
    ix = torch.clamp(ix, 0, ni - 1).long()  # the reference's mode="clip"
    iu = uids[ix]
    iv = vals[ix]
    nu = uid_slot.shape[0]
    if nu == 0:
        keep = torch.zeros_like(item_valid)
        slot = torch.full((b, k), -1, dtype=torch.int32, device=packed.device)
    else:
        uid_ok = (iu >= 0) & (iu < nu)
        su = torch.clamp(torch.where(uid_ok, iu, 0), 0, nu - 1).long()
        slot = uid_slot[su]
        owner = uid_col[su]
        keep = item_valid & uid_ok & (slot >= 0) & (owner == ev_col[:, None])
    slot2d = torch.where(keep, slot, -1).to(torch.int32)
    x2d = torch.where(keep, iv, 0.0)
    return slot2d, x2d


def route_offset(n_items: int, n_events: int) -> int:
    """Offset of the ``rows`` section in a packed chunk."""
    return 2 * n_items + 3 * n_events


def densify_map_packed_ref(
    packed: torch.Tensor,
    uid_slot: torch.Tensor,
    uid_col: torch.Tensor,
    src2d: torch.Tensor,
    *,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fused ``densify_map`` kernel: resolve
    (:func:`resolve_items_ref`), then densify and map
    (:func:`densify_map_ref`) with the routing read from ``packed``."""
    slot2d, x2d = resolve_items_ref(
        packed, uid_slot, uid_col, n_items=n_items, n_events=n_events, k=k
    )
    o = route_offset(n_items, n_events)
    rows = packed[o : o + n_rows]
    blks = packed[o + n_rows : o + 2 * n_rows]
    return densify_map_ref(slot2d, x2d, rows, blks, src2d, fill=fill)


def densify_map_shard_ref(
    packed: torch.Tensor,
    uid_slot: torch.Tensor,
    uid_col: torch.Tensor,
    src3d: torch.Tensor,
    *,
    n_items: int,
    n_events: int,
    n_rows: int,
    k: int,
    n_shards: int,
    shard_lo: int = 0,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``densify_map_shard``: resolve once
    (:func:`resolve_items_ref`, as the reference resolves replicated), then
    :func:`densify_map_ref` shard by shard.  ``packed``'s routing is the
    flattened (n_shards, n_rows) pair, all rows then all blks; ``src3d``
    holds the table slices of shards ``[shard_lo, shard_lo + len(src3d))``.
    Returns (out_values (len(src3d), n_rows, W), out_mask int8)."""
    slot2d, x2d = resolve_items_ref(
        packed, uid_slot, uid_col, n_items=n_items, n_events=n_events, k=k
    )
    o = route_offset(n_items, n_events)
    route = packed[o : o + 2 * n_shards * n_rows].view(2, n_shards, n_rows)
    outs = [densify_map_ref(slot2d, x2d, route[0, shard_lo + z], route[1, shard_lo + z],
                            t, fill=fill)
            for z, t in enumerate(src3d)]
    return _stack_shards(outs, n_rows, src3d.shape[2], x2d.dtype, packed.device)


def moe_combine_ref(expert_out: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """MoE combine: ``out[t, d] = sum_{e,c} combine[t, e, c] *
    expert_out[e, c, d]``.

    expert_out: (E, C, D) per-expert capacity-bucketed outputs, combine:
    (T, E, C) combine weights (router prob where token t occupies slot
    (e, c), else 0); float32 or bfloat16 each.  Returns (T, D) in
    ``expert_out.dtype``.  The contraction is an IEEE float32 multiply and
    sum over E*C, taken a slice of E*C at a time so the (T, slice, D)
    product stays under ~64 Mi elements; it never goes through a matrix
    unit, so ``torch.backends.cuda.matmul.allow_tf32`` cannot reach it.
    """
    t, e, c = combine.shape
    d = expert_out.shape[-1]
    cmb = combine.reshape(t, e * c).to(torch.float32)
    exp = expert_out.reshape(e * c, d).to(torch.float32)
    out = torch.zeros((t, d), dtype=torch.float32, device=exp.device)
    step = max(1, (1 << 26) // max(1, t * d))
    for k0 in range(0, e * c, step):
        out += (cmb[:, k0 : k0 + step, None] * exp[None, k0 : k0 + step]).sum(1)
    return out.to(expert_out.dtype)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    n_rep: int = 1,
) -> torch.Tensor:
    """Dense attention, the oracle of the flash kernel.

    q: (N, S, hd); k, v: (N // n_rep, T, hd) -- each KV head shared by
    ``n_rep`` adjacent query heads (GQA, ``repeat_interleave``).  Scores in
    float32, scaled by ``1/sqrt(hd)``; causal masks key j > query i with
    ``NEG_INF`` (absolute indices, also when S != T).  Returns (N, S, hd)
    in ``q.dtype``.  Its products are ``torch.matmul`` in float32: IEEE on
    the CPU, and on the card as long as ``allow_tf32`` is off (the default,
    and what ``chip_smoke.py`` sets).
    """
    s, hd = q.shape[1], q.shape[2]
    kk = k.to(torch.float32).repeat_interleave(n_rep, dim=0)
    vv = v.to(torch.float32).repeat_interleave(n_rep, dim=0)
    scores = torch.matmul(q.to(torch.float32), kk.transpose(1, 2)) / math.sqrt(hd)
    if causal:
        t = kk.shape[1]
        keep = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        scores = torch.where(keep[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, vv).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_valid: int) -> torch.Tensor:
    """One query token a row, q (B, H, hd), against slots ``0 .. n_valid -
    1`` of a KV cache k, v (B, T, KV, hd), query head ``h`` reading KV head
    ``h // (H / KV)``: softmax(q k^T / sqrt(hd)) v in float32, rounded once
    to q's dtype."""
    B, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, hd)
    s = torch.einsum("bghd,btgd->bght", qg, k[:, :n_valid].float()) / math.sqrt(hd)
    out = torch.einsum("bght,btgd->bghd", torch.softmax(s, dim=-1), v[:, :n_valid].float())
    return out.reshape(B, H, hd).to(q.dtype)
