"""Training step and loop of the PyTorch port."""
