"""Subband-domain MFCC, CMN, deltas, splicing and spectral subtraction (PyTorch).

Counterpart of `dsr_tpu/ops/features.py`: beamformed subband power goes
straight into the mel matrix (`mfcc_from_subbands`), with no
resynthesis.  The mel projection and DCT are float32 matmuls; they stay
in full float32 on the card because the entry points turn TF32 off
(`dsr_tpu_torch.utils.device.resolve`).  The time-domain `mfcc` (the
JAX package's `mfcc`: pre-emphasis, Hamming-windowed frames, an rfft, mel
and DCT) feeds BASELINE config 1.  `deltas` / `add_deltas` (regression
over ±window frames with edge replication), `splice` (adjacent-frame
stacking) and `spectral_subtraction` run where their input lies, as
slices and elementwise ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsr_tpu_torch.utils import profiling
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
    with profiling.scope("features.mfcc"):
        fmax = sample_rate / 2 if fmax is None else fmax
        W, C = _mel_dct(num_mel, num_cepstra, M // 2 + 1, sample_rate / M, fmin, fmax,
                        vtln_warp, Y.device)
        P = Y.abs() ** 2
        W, C = W.to(P.dtype), C.to(P.dtype)       # float32 matrices; float64 for complex128 Y
        mel_e = torch.clamp_min(P @ W.T, 1e-10)
        return torch.log(mel_e) @ C.T


def cmn(feats: torch.Tensor) -> torch.Tensor:
    """Per-utterance cepstral mean normalisation over the frame axis (-2)."""
    with profiling.scope("features.cmn"):
        return feats - feats.mean(dim=-2, keepdim=True)


def _edge_pad(feats: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Repeat the first frame `before` times and the last `after` times (axis -2)."""
    lead, F = feats.shape[:-2], feats.shape[-1]
    return torch.cat([feats[..., :1, :].expand(*lead, before, F), feats,
                      feats[..., -1:, :].expand(*lead, after, F)], dim=-2)


def deltas(feats: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Regression deltas over ±window frames (edge replication), axis -2."""
    denom = 2 * sum(d * d for d in range(1, window + 1))
    T = feats.shape[-2]
    padded = _edge_pad(feats, window, window)
    out = torch.zeros_like(feats)
    for d in range(1, window + 1):
        out = out + d * (padded[..., window + d:window + d + T, :]
                         - padded[..., window - d:window - d + T, :])
    return out / denom


def add_deltas(feats: torch.Tensor, window: int = 2) -> torch.Tensor:
    """[c, Δc, ΔΔc] stacking along the feature axis."""
    d1 = deltas(feats, window)
    d2 = deltas(d1, window)
    return torch.cat([feats, d1, d2], dim=-1)


def splice(feats: torch.Tensor, left: int = 3, right: int = 3) -> torch.Tensor:
    """Adjacent-frame stacking: frame t becomes frames t-left .. t+right
    side by side (edges replicated), (..., T, F) → (..., T, (left+right+1) F)."""
    T = feats.shape[-2]
    padded = _edge_pad(feats, left, right)
    return torch.cat([padded[..., off:off + T, :] for off in range(left + right + 1)], dim=-1)


def spectral_subtraction(P: torch.Tensor, noise_psd: torch.Tensor, alpha: float = 1.0,
                         floor: float = 0.1) -> torch.Tensor:
    """Power-domain spectral subtraction with flooring: max(P - α N, floor P)."""
    return torch.maximum(P - alpha * noise_psd, floor * P)
