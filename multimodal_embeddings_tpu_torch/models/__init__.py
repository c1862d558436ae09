"""PyTorch ports of the JAX package's models (one module per counterpart)."""
