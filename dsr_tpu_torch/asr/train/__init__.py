"""ML training of GMM-HMMs (PyTorch)."""
