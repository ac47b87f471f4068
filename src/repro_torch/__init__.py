"""repro_torch: the PyTorch / CUDA port of the METL mapping system.

The JAX package ``repro`` is the reference; this package imports nothing of
it (and no JAX).  Its layout mirrors ``repro``: ``core`` (registry, DPM,
state, plan lowering, conversion from the reference), ``etl`` (events,
control, plan manager, engine, app), ``kernels`` (hand-written CUDA kernels
for Hopper, their plain PyTorch versions, and the ops that call them),
``configs`` and ``models`` (the model zoo's dense family), ``serve`` (greedy
decode and the continuous-batching server) and ``launch`` (the serve
command).  Entry points run on the card by default and raise when there is
none; ``device="cpu"`` selects the plain versions.
"""
