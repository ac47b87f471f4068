"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions, and
the ops the engine calls.  Kernels build at first use (``build.py``)."""
