"""The paged serving engine of the PyTorch port."""
