"""Public entry points of the kernels, as the engines and models call them.

Counterpart of ``repro.kernels.ops``: the mapping ops of the consume paths,
and :func:`attention` and :func:`moe_combine` of the model stack.  Each op
picks kernel or plain version by the device of its tensors (a CUDA tensor
launches the Hopper kernel or raises, a CPU tensor takes the plain PyTorch
version); :func:`dmm_apply`'s ``impl`` picks the per-block *algorithm*, the
compacted gather or the one-hot contraction.

Dispatch handles, not results: every op returns its output tensors without
synchronising -- no ``.item()``, ``.cpu()``, ``.tolist()`` or
``torch.cuda.synchronize()`` here.  The engines' ``emit`` stage is the only
sync point.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .densify_map import densify_map
from .flash_attention import flash_attention
from .masked_gather import masked_gather
from .moe_combine import moe_combine as _moe_combine_kernel
from .onehot_map import onehot_map
from .segmented_gather import segmented_gather

__all__ = ["IMPLS", "dmm_apply", "dmm_apply_fused", "dmm_apply_columnar",
           "dispatch_count", "attention", "moe_combine"]

# Device-dispatch accounting: one per dmm_apply* call (the model ops are no
# mapping dispatches and do not count).  The fused-engine contract (one
# dispatch per consume chunk, not one per block) is asserted against it.
dispatch_count = 0

_PER_BLOCK = {"gather": masked_gather, "onehot": onehot_map}
IMPLS = tuple(_PER_BLOCK)  # the per-block algorithms dmm_apply takes


def dmm_apply(
    values: torch.Tensor,
    mask: torch.Tensor,
    src: torch.Tensor,
    *,
    impl: str = "gather",
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one compacted block (index vector ``src``) to a payload batch.

    impl:
      "gather"   the compacted masked gather (the DMM path,
                 :func:`~repro_torch.kernels.masked_gather.masked_gather`)
      "onehot"   the one-hot contraction (the paper's baseline,
                 :func:`~repro_torch.kernels.onehot_map.onehot_map`)

    Any other ``impl`` raises.
    """
    global dispatch_count
    fn = _PER_BLOCK.get(impl)
    if fn is None:
        raise ValueError(f"unknown impl {impl!r} (per-block: {sorted(_PER_BLOCK)})")
    dispatch_count += 1
    return fn(values, mask, src, fill=fill)


def dmm_apply_fused(
    values: torch.Tensor,
    mask: torch.Tensor,
    rows: torch.Tensor,
    blks: torch.Tensor,
    src2d: torch.Tensor,
    *,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply ALL compacted blocks a host-densified chunk touches in one
    dispatch (:func:`~repro_torch.kernels.segmented_gather.segmented_gather`).

    ``src2d`` is the state's stacked block table (built once per state by
    :func:`repro_torch.core.dmm_torch.compile_fused`); ``rows``/``blks``
    route output row ``s`` to (event row ``rows[s]``, block ``blks[s]``).
    """
    global dispatch_count
    dispatch_count += 1
    return segmented_gather(values, mask, rows, blks, src2d, fill=fill)


# The packed layout of one device-densify chunk (built by
# repro_torch.etl.engines._pack_columnar):
#
#     [ uids(NI) | val_bits(NI) | starts(B) | counts(B) | ev_col(B)
#       | rows(S) | blks(S) ]
#
# Values travel as int32 bit patterns, so the chunk is one int32 buffer and
# one host->device transfer.


def dmm_apply_columnar(
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
    """Resolve, densify and map a whole packed chunk in ONE dispatch
    (:func:`~repro_torch.kernels.densify_map.densify_map`).

    ``uid_slot``/``uid_col``/``src2d`` are the plan's device tables,
    uploaded once per state.  Returns ((n_rows, W) values, (n_rows, W) int8
    mask); rows past the true routing length are padding the caller slices
    off.
    """
    global dispatch_count
    dispatch_count += 1
    return densify_map(
        packed, uid_slot, uid_col, src2d, n_items=n_items, n_events=n_events,
        n_rows=n_rows, k=k, fill=fill,
    )


def moe_combine(expert_out: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """Combine expert outputs: (E, C, D), (T, E, C) -> (T, D)
    (:func:`~repro_torch.kernels.moe_combine.moe_combine`, which takes its
    operands the other way round)."""
    return _moe_combine_kernel(combine, expert_out)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    n_rep: int = 1,
) -> torch.Tensor:
    """Single-kernel attention: q (N, S, hd), k/v (N/n_rep, T, hd)
    (:func:`~repro_torch.kernels.flash_attention.flash_attention`)."""
    return flash_attention(q, k, v, causal=causal, n_rep=n_rep)
