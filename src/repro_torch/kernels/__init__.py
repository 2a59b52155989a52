"""Hand-written Hopper kernels of the PyTorch port, their plain versions
and dispatchers."""
