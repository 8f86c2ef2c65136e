"""The plain reference (PyTorch and numpy, float32, TF32 off) and the yardstick (peaks, work from shapes, the
comparisons). Nothing here imports the port or JAX."""
