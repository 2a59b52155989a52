"""Command-line launchers of the PyTorch port."""
