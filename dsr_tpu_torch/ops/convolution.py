"""Overlap-add / overlap-save FIR filtering (PyTorch).

Counterpart of `dsr_tpu/ops/convolution.py`: every block's product with
the response's spectrum is one batched rFFT, on the device of the input.
The overlap-add of the blocks (also the synthesis of `ops/cmfb.py` and
`ops/prfft.py`) is `overlap_add_frames`: each output hop is a sum of
fixed slices of the frames, added in a fixed order, so the result does
not vary from run to run as an atomic scatter-add would.
"""

from __future__ import annotations

import numpy as np
import torch


def overlap_add_frames(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Σ_t frames[..., t, :] placed at t·hop: (..., T, n) → (..., (T+q-1)·hop),
    q = ceil(n / hop); every sample from (T-1)·hop + n on is zero."""
    T, n = frames.shape[-2:]
    q = -(-n // hop)
    parts = torch.nn.functional.pad(frames, (0, q * hop - n)).reshape(*frames.shape[:-2], T, q,
                                                                      hop)
    out = frames.new_zeros(*frames.shape[:-2], T + q - 1, hop)
    for i in range(q):
        out[..., i:i + T, :] += parts[..., :, i, :]
    return out.reshape(*frames.shape[:-2], (T + q - 1) * hop)


def _response_spectrum(h: torch.Tensor, nfft: int, device: torch.device) -> torch.Tensor:
    return torch.fft.rfft(torch.as_tensor(h, dtype=torch.float32, device=device), nfft)


def overlap_add(x: torch.Tensor, h, block: int = 1024) -> torch.Tensor:
    """y = (h * x)[: len(x)] block-wise.  x: (..., S), h: (L,)."""
    S = x.shape[-1]
    L = h.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(block + L - 1)))
    nb = -(-S // block)
    blocks = torch.nn.functional.pad(x, (0, nb * block - S)).reshape(*x.shape[:-1], nb, block)
    H = _response_spectrum(h, nfft, x.device)
    Y = torch.fft.irfft(torch.fft.rfft(blocks, nfft, dim=-1) * H, nfft, dim=-1)
    return overlap_add_frames(Y[..., :block + L - 1], block)[..., :S]


def overlap_save(x: torch.Tensor, h, block: int = 1024) -> torch.Tensor:
    """Same result as overlap_add, via the overlap-save formulation."""
    S = x.shape[-1]
    L = h.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(block + L - 1)))
    step = nfft - (L - 1)
    nb = -(-S // step)
    xp = torch.nn.functional.pad(x, (L - 1, nb * step + nfft - S))
    blocks = xp.unfold(-1, nfft, step)[..., :nb, :]                 # (..., nb, nfft)
    H = _response_spectrum(h, nfft, x.device)
    Y = torch.fft.irfft(torch.fft.rfft(blocks, nfft, dim=-1) * H, nfft, dim=-1)
    return Y[..., L - 1:L - 1 + step].reshape(*x.shape[:-1], nb * step)[..., :S]
