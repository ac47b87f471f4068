"""Model configuration schema for the 10-architecture zoo.

One frozen dataclass covers every family (dense / moe / ssm / hybrid /
audio / vlm); family-specific fields are zero/None when unused.  The exact
assigned configs live in :mod:`repro_torch.configs` -- one module per arch
id.  Field names and values are the JAX reference's, so two configs compare
field for field; only :attr:`ModelConfig.pdtype` / :attr:`ModelConfig.cdtype`
return ``torch`` dtypes.

``attn_impl`` keeps the reference's values: ``"dense"`` (the full score
matrix), ``"chunked"`` (online softmax over key chunks, plain PyTorch) and
``"pallas"``, which in this package means the hand-written Hopper kernel
:func:`repro_torch.kernels.flash_attention.flash_attention` (its plain
version on CPU tensors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "VOCAB_ALIGN"]

# Vocab axes are padded to this multiple so every arch's embedding table can
# be sharded evenly over a 16-wide model axis (51865 and 151655 are not even
# divisible by 2).  Pad logits are masked to -inf in the loss.
VOCAB_ALIGN = 256


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: int = 0  # 0 => d_model // n_heads
    window: int = 0  # 0 => full causal; >0 => sliding-window attention
    rope_theta: float = 10_000.0

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # ssm (rwkv / mamba-in-hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0  # rwkv heads; 0 => d_model // 64

    # families / flavour
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    activation: str = "swiglu"  # swiglu | gelu
    pos: str = "rope"  # rope | learned | none
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 0  # encoder frontend length (whisper frames / vit patches)
    frontend_tokens: int = 0  # vlm: patch embeddings prepended to the text
    tie_embeddings: bool = False
    max_seq: int = 524_288

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # training-time knobs (overridable per run)
    remat: str = "full"  # none | full | dots
    scan_unroll: bool = False  # unroll the layer scan (dry-run cost pass)
    attn_impl: str = "dense"  # dense | chunked (online softmax) | pallas (Hopper kernel)
    rwkv_impl: str = "scan"  # scan (exact recurrence) | chunked (GLA-style)
    dryrun_n_micro: int = 0  # per-arch microbatch override (0 = size-tiered)
    # store the per-layer scan carry sequence-sharded over the model axis
    # (Megatron-SP-style): the remat stack divides by the TP width; the body
    # all-gathers S per layer (cheap vs the stack's HBM footprint at 405B)
    sp_carry: bool = False
    moe_impl: str = "dense"  # dense (einsum) | dmm (sort/gather) | ep (shard_map all-to-all)

    # ---- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, VOCAB_ALIGN)

    @property
    def n_rwkv_heads(self) -> int:
        return self.ssm_heads or self.d_model // 64

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? SSM state or windowed attn."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter accounting (for MODEL_FLOPS = 6*N*D roofline term) -------
    def param_count(self) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_padded, self.n_layers
        hd = self.hd
        n = 0
        # embeddings (+ untied lm head)
        n += V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":  # rwkv6
            H = self.n_rwkv_heads
            per_layer += 4 * D * D  # r, k, v, output
            per_layer += D * D  # gate
            per_layer += 6 * 2 * D * 32  # token-shift loras (x_maa)
            per_layer += 2 * D * 64  # decay lora
            per_layer += 2 * D  # decay base + bonus u
            per_layer += 2 * D + H * 64  # ln scales + group-norm
            per_layer += D * F + F * D + D * D  # channel mix (k, v, r)
        else:
            # attention
            att = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
            if self.family == "hybrid":
                Di, N = D, self.ssm_state
                dt_rank = max(1, math.ceil(D / 16))
                ssm = (
                    D * 2 * Di  # in_proj (x, z)
                    + Di * 4  # conv
                    + Di * (dt_rank + 2 * N)  # x_proj
                    + dt_rank * Di  # dt_proj
                    + Di * N + Di  # A_log, D
                    + Di * D  # out_proj
                )
                per_layer += att + ssm
            else:
                per_layer += att
            # mlp / moe
            if self.is_moe:
                per_layer += D * self.n_experts  # router
                per_layer += self.n_experts * (2 * D * F + F * D)  # swiglu experts
            else:
                mults = 3 if self.activation == "swiglu" else 2
                per_layer += mults * D * F
            # norms
            if self.norm != "nonparametric_ln":
                per_layer += 2 * D
        n += per_layer * L
        if self.enc_dec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = (4 * D * D + 2 * D * F + 2 * D) * self.enc_layers
            dec_cross = (4 * D * D + D) * L
            n += enc + dec_cross
            n += self.enc_seq * D + self.max_seq_emb() * D  # learned pos (enc+dec)
        return n

    def max_seq_emb(self) -> int:
        # whisper's real decoder caps at 448 learned positions; the assigned
        # prefill/decode cells go to 32k, so the table is extended (DESIGN SS6)
        return 32_768 if self.family == "audio" else 0

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        full_experts = self.n_experts * (2 * D * F + F * D) * L
        active_experts = self.top_k * (2 * D * F + F * D) * L
        return self.param_count() - full_experts + active_experts
