"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (OLMo's distinguishing choice), SwiGLU, RoPE.
[arXiv:2402.00838; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="nonparametric_ln",
    activation="swiglu",
    pos="rope",
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512)
