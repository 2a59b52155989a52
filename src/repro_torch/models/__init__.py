"""Model layers of the PyTorch port: the dense FAL decoder."""
