"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

InternViT frontend is a stub -- input_specs() provides precomputed patch
embeddings (256 tokens) prepended to the text stream; the LM backbone is
the Qwen2-0.5B-shaped decoder above.  [arXiv:2404.16821; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    frontend_tokens=256,
    norm="rmsnorm",
    activation="swiglu",
    pos="rope",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
    frontend_tokens=8,
)
