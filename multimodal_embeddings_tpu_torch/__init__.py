"""multimodal_embeddings_tpu_torch — the page program of
``multimodal_embeddings_tpu`` ported to PyTorch and CUDA for one NVIDIA
H100.

Module paths mirror the JAX package (``models/yolo.py`` ports
``multimodal_embeddings_tpu/models/yolo.py``), which stays the reference.
This package imports ``torch`` and numpy, never ``jax``, ``flax`` or the
JAX package: it keeps its own copies of the jax-free host code it needs
(``config.py``, ``ops/grid.py``, ``io/``). Kernels are
CUDA C++ for ``sm_90a`` under ``csrc/``, built by ``kernels/_build.py`` at
first use.
"""

__version__ = "0.1.0"
