"""Subband DSP and feature ops (PyTorch), CUDA kernels under `cuda/`."""
