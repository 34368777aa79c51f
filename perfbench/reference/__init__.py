"""Plain references: PyTorch or NumPy only, importing nothing of the
program (``repro_torch``) or of the JAX package."""
