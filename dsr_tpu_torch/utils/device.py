"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device`, or the card when the caller names none.

    Raises when CUDA is asked for (or implied) and no card is present: the
    port never falls back to the CPU by itself.  On the card it turns TF32
    off for float32 matmuls (PyTorch's default, set here so a changed
    default cannot make card results drift from the plain path's) and for
    cuDNN's convolutions (on by default: the models' convolutions would
    otherwise round their inputs to TF32 and miss the CPU plain path by
    ~1e-3).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dsr_tpu_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
