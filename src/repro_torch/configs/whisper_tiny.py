"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865.

Encoder-decoder; the conv frontend is a stub -- input_specs() provides
precomputed frame embeddings (B, 1500, 384).  Learned positions, GELU,
LayerNorm.  The decoder positional table is extended to 32k so the assigned
prefill/decode cells are well-defined (real whisper caps at 448).
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    activation="gelu",
    pos="learned",
    enc_dec=True,
    enc_layers=4,
    enc_seq=1500,
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab=512, enc_seq=32,
)
