"""repro_torch: the PyTorch / CUDA port of the METL mapping system.

The JAX package ``repro`` is the reference; this package imports nothing of
it (and no JAX).  Its layout mirrors ``repro``: ``core`` (registry, DPM,
state, plan lowering), ``etl`` (events, control, plan manager, engine, app)
and ``kernels`` (hand-written CUDA kernels for Hopper, their plain PyTorch
versions, and the ops the engine calls).  Entry points run on the card by
default and raise when there is none; ``device="cpu"`` selects the plain
versions.
"""
