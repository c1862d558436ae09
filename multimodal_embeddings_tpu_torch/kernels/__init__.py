"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
their build (``_build.py``)."""
