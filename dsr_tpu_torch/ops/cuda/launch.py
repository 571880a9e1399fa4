"""What every kernel wrapper of the port does before a launch: dispatch on
the device of its tensors, check what the kernel takes, and name the
caller's stream."""

from __future__ import annotations

import ctypes

import torch


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors must all be on one CUDA device or all on "
                         f"the CPU, got {[str(t.device) for t in tensors]}")
    return True


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless t is a contiguous tensor of this dtype and shape."""
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for a kernel's launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
