"""The model zoo on PyTorch: configuration, layers, attention with a KV
cache, the MoE FFN, the RWKV-6 and Mamba blocks, and the full model
(``init_params``, ``forward``, ``init_decode_state``, ``decode_step``)."""
