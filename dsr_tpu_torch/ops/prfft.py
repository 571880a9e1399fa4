"""Perfect-reconstruction FFT filterbank (PyTorch).

Counterpart of `dsr_tpu/ops/prfft.py`, with the port's copies of
`golden/prfft.py`'s `design_cola_window` and `num_frames`: a windowed-FFT
bank with hop D | M and a self-dual window whose squares overlap-add to
one, so synthesis∘analysis is exact to float rounding; critically sampled
at D = M.  Analysis is the signal's hop views times the window and one
batched rFFT; synthesis an inverse rFFT, the window and
`convolution.overlap_add_frames`.
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.ops.convolution import overlap_add_frames


def design_cola_window(M: int, D: int) -> np.ndarray:
    """Self-dual PR window for hop D: sqrt of a periodic Hann, renormalised
    so Σ_t w²[n − tD] ≡ 1 exactly (requires D | M)."""
    if M % D != 0:
        raise ValueError(f"the PR-FFT bank needs the hop D={D} to divide the window length M={M}")
    if D == M:
        return np.ones(M)
    w2 = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(M) / M)  # periodic Hann
    # exact COLA normalisation: divide by the (D-periodic) overlap sum
    s = np.zeros(M)
    for t in range(-(M // D) + 1, M // D):
        idx = np.arange(M) - t * D
        ok = (idx >= 0) & (idx < M)
        s[ok] += w2[idx[ok]]
    return np.sqrt(w2 / s)


def num_frames(S: int, M: int, D: int) -> int:
    # M/D − 1 extra tail frames: every sample (incl. the last) must receive
    # all M/D overlapping window contributions for the COLA identity
    return int(np.ceil(S / D)) + M // D - 1


def _window(window, M: int, D: int, device: torch.device) -> torch.Tensor:
    w = design_cola_window(M, D) if window is None else window
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def analysis(x: torch.Tensor, M: int, D: int, window=None) -> torch.Tensor:
    """(..., S) → (..., T, M//2+1) complex64; frame t covers x[tD − (M−D) .. +M)."""
    S = x.shape[-1]
    T = num_frames(S, M, D)
    P = M - D
    xp = torch.nn.functional.pad(x.to(torch.float32), (P, T * D + M - P - S))
    frames = xp.unfold(-1, M, D)[..., :T, :] * _window(window, M, D, x.device)
    return torch.fft.rfft(frames, dim=-1)


def synthesis(A: torch.Tensor, M: int, D: int, out_len: int, window=None) -> torch.Tensor:
    """(..., T, M//2+1) → (..., out_len) float32: inverse rFFT, window, overlap-add.

    The imaginary parts of the DC bin (and of the Nyquist bin, M even) are
    zeroed first: a real signal's spectrum has none, NumPy and XLA ignore
    them, and cuFFT's inverse does not at some shapes.
    """
    A = A.to(torch.complex64)
    keep = torch.ones(A.shape[-1], dtype=torch.float32, device=A.device)
    keep[0] = 0.0
    if M % 2 == 0:
        keep[-1] = 0.0
    A = torch.complex(A.real, A.imag * keep)
    T = A.shape[-2]
    v = torch.fft.irfft(A, M, dim=-1) * _window(window, M, D, A.device)
    y = overlap_add_frames(v, D)
    start = min(M - D, T * D + M - out_len)             # the JAX slice's clamp
    return y[..., start:start + out_len]
