"""PyTorch ports of the JAX package's device ops (one module per counterpart)."""
