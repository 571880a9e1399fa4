"""Objective speech-quality measures: segmental SNR, frequency-weighted
segmental SNR and SI-SDR.

The port's copy of `dsr_tpu/utils/objective.py`, with the mel matrix from
`utils.design`.  NumPy: these score a run's outputs on the host and are
not on the hot path.
"""

from __future__ import annotations

import numpy as np

from dsr_tpu_torch.utils.design import mel_filterbank


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR (dB)."""
    ref = ref - ref.mean()
    est = est - est.mean()
    alpha = np.dot(est, ref) / (np.dot(ref, ref) + 1e-12)
    target = alpha * ref
    noise = est - target
    return float(10 * np.log10((np.sum(target**2) + 1e-12) / (np.sum(noise**2) + 1e-12)))


def segmental_snr(est: np.ndarray, ref: np.ndarray, frame: int = 256,
                  floor_db: float = -10.0, ceil_db: float = 35.0) -> float:
    """Mean per-frame SNR (dB), clamped to the usual [-10, 35] range."""
    n = min(len(est), len(ref)) // frame * frame
    e = est[:n].reshape(-1, frame)
    r = ref[:n].reshape(-1, frame)
    err = e - r
    snr = 10 * np.log10((np.sum(r**2, 1) + 1e-12) / (np.sum(err**2, 1) + 1e-12))
    return float(np.mean(np.clip(snr, floor_db, ceil_db)))


def fw_segmental_snr(est: np.ndarray, ref: np.ndarray, sample_rate: float = 16000.0,
                     nfft: int = 512, hop: int = 256, num_bands: int = 23) -> float:
    """Frequency-weighted segSNR over mel-spaced bands, weighted by the
    reference band energy (the classic fwSNRseg)."""
    n = min(len(est), len(ref))
    frames = max(0, 1 + (n - nfft) // hop)
    if frames == 0:
        return si_sdr(est, ref)
    W = mel_filterbank(num_bands, np.arange(nfft // 2 + 1) * sample_rate / nfft,
                       50.0, sample_rate / 2)
    win = np.hanning(nfft)
    tot, wsum = 0.0, 0.0
    for t in range(frames):
        seg_r = ref[t * hop : t * hop + nfft] * win
        seg_e = est[t * hop : t * hop + nfft] * win
        R = np.abs(np.fft.rfft(seg_r)) ** 2 @ W.T
        E = np.abs(np.fft.rfft(seg_e)) ** 2 @ W.T
        snr = 10 * np.log10((R + 1e-12) / (np.abs(R - E) + 1e-12))
        wgt = R ** 0.2
        tot += float(np.sum(wgt * np.clip(snr, -10, 35)))
        wsum += float(np.sum(wgt))
    return tot / max(wsum, 1e-12)
