"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936,
MoE 128 experts top-8 (fine-grained experts; d_ff is per-expert).

[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    n_experts=128,
    top_k=8,
    norm="rmsnorm",
    activation="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=48, vocab=512,
    n_experts=8, top_k=2,
)
