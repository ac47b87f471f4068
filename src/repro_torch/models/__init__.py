"""The model zoo's dense family on PyTorch: configuration, layers,
attention with a KV cache, and the full model (``init_params``,
``forward``, ``init_decode_state``, ``decode_step``)."""
