"""Tensor ops for the PyTorch port: norms, rope, paged attention."""
