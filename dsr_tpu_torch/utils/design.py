"""Design-time NumPy helpers of the front end, and the prototype loader.

Copies of `golden.room.steering_delays`, `golden.features.mel_filterbank`
/ `dct_matrix` (with the mel and VTLN helpers they call) and
`golden.filterbank.num_frames`, so that the port imports nothing of the
JAX package or its oracles.  The filterbank prototypes are the `.npz`
files shipped beside this module, copied from `dsr_tpu/ops/prototypes/`;
designing a prototype for a config without a shipped file is not ported.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

from dsr_tpu_torch.config import FilterbankConfig

PROTOTYPE_DIR = pathlib.Path(__file__).parent / "prototypes"


def steering_delays(
    mic_positions: np.ndarray, source_pos: np.ndarray, sound_speed: float, sample_rate: float
) -> np.ndarray:
    """Per-mic propagation delay in samples, relative to the array origin.

    Near-field (point-source) model: τ_n = (|p_n - s| - |s|) / c.
    """
    d = np.linalg.norm(mic_positions - source_pos[None, :], axis=1)
    d0 = np.linalg.norm(source_pos)
    return (d - d0) / sound_speed * sample_rate


def num_frames(S: int, M: int, m: int, r: int) -> int:
    """Frame count covering S samples incl. pad and synthesis tail."""
    L, D = m * M, M // r
    return -(-(S + (L - D) + L) // D)


def mel_scale(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def inv_mel_scale(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def vtln_warp_freq(f, alpha: float, f_low: float, f_high: float):
    """Kaldi-style piecewise-linear VTLN warp of physical frequency."""
    f = np.asarray(f, dtype=np.float64)
    scale = 1.0 / alpha
    l = f_low * max(1.0, scale)
    h = f_high * min(1.0, scale)
    slope_l = (scale * l - f_low) / (l - f_low) if l > f_low else scale
    slope_r = (f_high - scale * h) / (f_high - h) if h < f_high else scale
    out = scale * f
    lo = f < l
    hi = f > h
    out[lo] = f_low + slope_l * (f[lo] - f_low)
    out[hi] = f_high - slope_r * (f_high - f[hi])
    return out


def mel_filterbank(
    num_mel: int,
    bin_freqs: np.ndarray,
    fmin: float,
    fmax: float,
    vtln_warp: float = 1.0,
) -> np.ndarray:
    """Triangular mel filter matrix over arbitrary bin centre freqs.

    → (num_mel, len(bin_freqs)).  Works for rFFT bins and for subband bins.
    """
    m_lo, m_hi = mel_scale(fmin), mel_scale(fmax)
    centers_mel = np.linspace(m_lo, m_hi, num_mel + 2)
    centers = inv_mel_scale(centers_mel)
    if vtln_warp != 1.0:
        centers = vtln_warp_freq(centers, vtln_warp, f_low=fmin, f_high=fmax)
        centers = np.clip(centers, fmin, fmax)
    W = np.zeros((num_mel, len(bin_freqs)))
    for i in range(num_mel):
        left, mid, right = centers[i], centers[i + 1], centers[i + 2]
        up = (bin_freqs - left) / max(mid - left, 1e-10)
        down = (right - bin_freqs) / max(right - mid, 1e-10)
        W[i] = np.maximum(0.0, np.minimum(up, down))
    return W


def dct_matrix(num_cepstra: int, num_mel: int) -> np.ndarray:
    """Orthonormal DCT-II rows 0..num_cepstra-1: (num_cepstra, num_mel)."""
    n = np.arange(num_mel)
    k = np.arange(num_cepstra)[:, None]
    C = np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * num_mel))
    C *= np.sqrt(2.0 / num_mel)
    C[0] *= np.sqrt(0.5)
    return C


@functools.lru_cache(maxsize=32)
def get_prototypes(cfg: FilterbankConfig) -> tuple[np.ndarray, np.ndarray, int]:
    """Designed (hf, gf, delay) for a config, from the shipped `.npz` files.

    The arrays are cached and shared between callers: do not write to them.
    """
    key = f"proto-M{cfg.M}-m{cfg.m}-r{cfg.r}-b{cfg.rolloff:g}-j{cfg.joint_iters}.npz"
    path = PROTOTYPE_DIR / key
    if not path.exists():
        shipped = sorted(p.name for p in PROTOTYPE_DIR.glob("proto-*.npz"))
        raise ValueError(
            f"no shipped filterbank prototype for {cfg} (looked for {key}); "
            f"shipped: {shipped}.  Pass hf/gf explicitly; prototype design "
            "is not ported yet (ROADMAP)."
        )
    with np.load(path) as z:
        return z["hf"], z["gf"], int(z["delay"])
