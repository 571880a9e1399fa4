"""Subband-domain MFCC and cepstral mean normalisation (PyTorch).

Counterpart of `mfcc_from_subbands` and `cmn` in `dsr_tpu/ops/features.py`:
beamformed subband power goes straight into the mel matrix, with no
resynthesis.  The mel projection and DCT are float32 matmuls; they stay in
full float32 on the card because the entry points turn TF32 off
(`dsr_tpu_torch.utils.device.resolve`).  The time-domain `mfcc` (the
JAX package's `mfcc`: pre-emphasis, Hamming-windowed frames, an rfft, mel
and DCT) feeds BASELINE config 1.  `deltas` and `splice` are later work
(ROADMAP).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsr_tpu_torch.utils.design import dct_matrix, mel_filterbank


@functools.lru_cache(maxsize=64)
def _mel_dct(num_mel: int, num_ceps: int, nbins: int, bin_hz: float, fmin: float,
             fmax: float, warp: float, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Mel and DCT matrices as float32 tensors, copied to `device` once."""
    freqs = np.arange(nbins) * bin_hz
    W = mel_filterbank(num_mel, freqs, fmin, fmax, warp).astype(np.float32)
    C = dct_matrix(num_ceps, num_mel).astype(np.float32)
    return torch.as_tensor(W, device=device), torch.as_tensor(C, device=device)


def mfcc(
    x: torch.Tensor,
    sample_rate: float = 16000.0,
    num_mel: int = 30,
    num_cepstra: int = 13,
    fmin: float = 20.0,
    fmax: float | None = None,
    preemph: float = 0.97,
    frame_len: int = 400,
    hop: int = 160,
    nfft: int = 512,
    vtln_warp: float = 1.0,
) -> torch.Tensor:
    """Time-domain MFCC: (..., S) float32 → (..., T, num_cepstra), T =
    1 + (S - frame_len) // hop frames."""
    fmax = sample_rate / 2 if fmax is None else fmax
    W, C = _mel_dct(num_mel, num_cepstra, nfft // 2 + 1, sample_rate / nfft, fmin, fmax,
                    vtln_warp, x.device)
    xp = torch.cat([x[..., :1], x[..., 1:] - preemph * x[..., :-1]], dim=-1)
    window = torch.as_tensor(np.hamming(frame_len).astype(np.float32), device=x.device)
    frames = xp.unfold(-1, frame_len, hop) * window
    P = torch.fft.rfft(frames, n=nfft, dim=-1).abs() ** 2
    mel_e = torch.clamp_min(P @ W.T, 1e-10)
    return torch.log(mel_e) @ C.T


def mfcc_from_subbands(
    Y: torch.Tensor,
    M: int,
    sample_rate: float = 16000.0,
    num_mel: int = 30,
    num_cepstra: int = 13,
    fmin: float = 20.0,
    fmax: float | None = None,
    vtln_warp: float = 1.0,
) -> torch.Tensor:
    """Subband-domain MFCC: (..., T, M//2+1) complex → (..., T, num_cepstra)."""
    fmax = sample_rate / 2 if fmax is None else fmax
    W, C = _mel_dct(num_mel, num_cepstra, M // 2 + 1, sample_rate / M, fmin, fmax, vtln_warp,
                    Y.device)
    P = Y.abs() ** 2
    mel_e = torch.clamp_min(P @ W.T, 1e-10)
    return torch.log(mel_e) @ C.T


def cmn(feats: torch.Tensor) -> torch.Tensor:
    """Per-utterance cepstral mean normalisation over the frame axis (-2)."""
    return feats - feats.mean(dim=-2, keepdim=True)
