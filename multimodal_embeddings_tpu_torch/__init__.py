"""multimodal_embeddings_tpu_torch — the page program of
``multimodal_embeddings_tpu`` ported to PyTorch and CUDA for one NVIDIA
H100.

Module paths mirror the JAX package (``models/yolo.py`` ports
``multimodal_embeddings_tpu/models/yolo.py``), which stays the reference.
This package imports ``torch`` and numpy, never ``jax`` or ``flax``; from
the JAX package it takes only the jax-free ``config`` module. Kernels are
CUDA C++ for ``sm_90a`` under ``csrc/``, built by ``kernels/_build.py`` at
first use.
"""

__version__ = "0.1.0"
