"""Engine-facing protocol types for the PyTorch port."""
