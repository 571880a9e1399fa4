"""Published peaks of the chips the benchmark runs on, and the least time
a piece of work can take at them.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
limit: HBM3 at 3.35 TB/s and 67 TFLOP/s in float32 outside the tensor
cores.  Every kernel the benchmark counts computes in float32 outside the
tensor cores (the port turns TF32 off), so float32 is the peak for
operations.  A card set below 700 W runs slower under load: the run prints
its power limit beside its numbers.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time for `nbytes` moved and `flops` computed: the larger
    of bytes over the memory's peak and operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
