"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 -- parallel attention + mamba heads, outputs mean-fused.

Sliding-window attention (1k) on all layers (the paper's periodic global
layers are simplified to all-windowed for 500k-decode runnability; recorded
in DESIGN.md SS6).  [arXiv:2411.13676; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    window=1024,
    norm="rmsnorm",
    activation="swiglu",
    pos="rope",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
    ssm_state=4, window=16,
)
