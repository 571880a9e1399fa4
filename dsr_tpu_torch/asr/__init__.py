"""Speech recognition back end (PyTorch): acoustic models."""
