"""rwkv6-3b [ssm] "Finch": 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.

Data-dependent decay linear recurrence; token-shift mixing; O(1) decode
state => runs the long_500k cell.  [arXiv:2404.05892; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    norm="layernorm",
    activation="relu_sq",  # rwkv channel-mix uses relu^2 internally
    pos="none",
    # SSPerf rwkv iterations 1-3: chunked (GLA-style) wkv form + 4 microbatches
    # (scan-exact baseline reachable via rwkv_impl="scan"; allclose-tested)
    rwkv_impl="chunked",
    dryrun_n_micro=4,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, d_ff=192, vocab=512)
