"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

GQA with a 128k vocabulary; rope_theta=500k per the Llama-3 report.
[arXiv:2407.21783; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500_000.0,
    norm="rmsnorm",
    activation="swiglu",
    pos="rope",
    # SSPerf llama iteration 4: 16 microbatches halve the remat carry stack
    # (118.7 -> 67.7 GB/dev CPU-proxy temp); clamped to batch/dp on the
    # multi-pod mesh by train_settings
    dryrun_n_micro=16,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=192, vocab=512)
