"""Model configurations of the PyTorch port (data, as in ``repro.configs``)."""
