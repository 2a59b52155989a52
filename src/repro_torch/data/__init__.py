"""Token data sources of the PyTorch port (numpy, no torch)."""
