"""Sub-package of the PyTorch port."""
