"""Model definitions (dense Llama family) for the PyTorch port."""
