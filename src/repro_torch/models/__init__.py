"""The model zoo on PyTorch: configuration, layers, attention with a KV
cache and cross-attention, the MoE FFN, the RWKV-6 and Mamba blocks, and
the full model over the six families -- dense, moe, ssm, hybrid, audio
(encoder-decoder) and vlm (patch prefix) -- (``init_params``, ``forward``,
``init_decode_state``, ``prefill_memory``, ``decode_step``)."""
