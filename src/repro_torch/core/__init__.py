"""FAL connection modes and the execution plan of the PyTorch port."""
