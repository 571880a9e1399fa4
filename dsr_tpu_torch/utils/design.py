"""Design-time NumPy helpers of the front end, and the filterbank prototypes.

Copies of `golden.room.steering_delays`, `golden.features.mel_filterbank`
/ `dct_matrix` (with the mel and VTLN helpers they call) and of
`golden.filterbank`'s `num_frames` and prototype design
(`design_prototypes`, `pr_error_db` and the least-squares helpers they
call), so that the port imports nothing of the JAX package or its
oracles.  `get_prototypes` loads the `.npz` files shipped beside this
module (copied from `dsr_tpu/ops/prototypes/`) and designs the pair of
any other config, as the JAX package does; designs are memoised in the
process and never written to disk.
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


def _sqrt_raised_cosine(L: int, M: int, rolloff: float, center: int) -> np.ndarray:
    """Square-root raised-cosine lowpass, band edge pi/M, sampled at n-center.

    Built by dense frequency sampling + IDFT — exact spectral square root of
    a raised cosine, so h*h (correlation) is Nyquist(M) up to truncation.
    """
    NF = 64 * L
    w = np.abs(np.fft.fftfreq(NF) * 2 * np.pi)
    wc = np.pi / M
    lo, hi = wc * (1 - rolloff), wc * (1 + rolloff)
    P = np.where(w <= lo, 1.0, np.where(w >= hi, 0.0, 0.5 * (1 + np.cos(np.pi / (2 * rolloff * wc) * (w - lo)))))
    h_inf = np.fft.ifft(np.sqrt(P)).real
    return h_inf[(np.arange(L) - center) % NF]


def design_analysis_prototype(
    M: int, m: int, r: int, rolloff: float = 1.0, win_beta: float = 6.0
) -> np.ndarray:
    """Windowed sqrt-raised-cosine analysis prototype, length L = m*M.

    Normalised so sum(hf) = 1 (unit DC gain in bin 0).
    """
    L = m * M
    h = _sqrt_raised_cosine(L, M, rolloff, L // 2) * np.kaiser(L, win_beta)
    return h / h.sum()


def _pr_system(hf: np.ndarray, M: int, m: int, r: int, delay: int):
    """Linear PR system R @ gf = target for overall (padded-coords) delay.

    Rows are (residue τ in [0,D), lag d ∈ {-(m-1)M .. (m-1)M} step M):
        sum_{j ≡ τ (mod D)} hf[j - d] * gf[j]  =  δ[d - delay]
    """
    L = m * M
    D = M // r
    lags = np.arange(-(m - 1), m) * M
    rows = []
    tgt = []
    for tau in range(D):
        js = np.arange(tau, L, D)
        for d in lags:
            row = np.zeros(L)
            jd = js - d
            ok = (jd >= 0) & (jd < L)
            row[js[ok]] = hf[jd[ok]]
            rows.append(row)
            tgt.append(1.0 if d == delay else 0.0)
    return np.asarray(rows), np.asarray(tgt)


def _stopband_gram(L: int, omega_s: float) -> np.ndarray:
    """Gram matrix Q with g^T Q g = (1/pi) ∫_{ωs}^{π} |G(e^{jω})|² dω."""
    k = np.arange(L)
    diff = k[:, None] - k[None, :]
    Q = np.where(diff == 0, (np.pi - omega_s), -np.sin(omega_s * diff) / np.where(diff == 0, 1, diff))
    return Q / np.pi


def _reg_solve(R, t, Q, lam):
    RtR, Rtt = R.T @ R, R.T @ t
    scale = np.trace(RtR) / max(np.trace(Q), 1e-30)
    return np.linalg.solve(RtR + lam * scale * Q, Rtt)


def design_synthesis_prototype(
    hf: np.ndarray,
    M: int,
    m: int,
    r: int,
    lam: float = 1e-3,
    rolloff: float = 1.0,
) -> tuple[np.ndarray, int]:
    """Synthesis prototype gf for a given hf, and the design delay (= 0).

    Minimises ||R gf - t||² + λ·(stopband energy of gf beyond (1+β)π/M·1.1),
    i.e. total response error vs. leakage — the de Haan tradeoff [K].
    λ = 1e-3 lands at ≈ -80 dB PR with ≈ -45 dB synthesis stopband for the
    standard r=2 configurations.
    """
    L = m * M
    Q = _stopband_gram(L, np.pi / M * (1 + rolloff) * 1.1)
    R, t = _pr_system(hf, M, m, r, 0)
    return _reg_solve(R, t, Q, lam), 0


def design_prototypes(
    M: int,
    m: int,
    r: int,
    joint_iters: int = 2,
    lam: float = 1e-3,
    rolloff: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Full (hf, gf, delay) design with optional alternating refinement.

    The PR system is bilinear and role-symmetric in (hf, gf) at delay 0, so
    alternating the regularised LS between the two prototypes balances their
    stopbands (≈ -41 dB each at PR ≈ -83 dB for M=256, m=4, r=2).  With
    joint_iters=0 this is the plain hf-then-gf design.  For r = 1 use more
    iterations (≥ 6); PR saturates near -35 dB (fundamental for critically
    sampled DFT banks).
    """
    L = m * M
    Q = _stopband_gram(L, np.pi / M * (1 + rolloff) * 1.1)
    hf = design_analysis_prototype(M, m, r, rolloff)
    gf, _ = design_synthesis_prototype(hf, M, m, r, lam, rolloff)
    for _ in range(joint_iters):
        # Fix gf, solve hf: the role swap with delay 0 is the same system.
        R, t = _pr_system(gf, M, m, r, 0)
        hf = _reg_solve(R, t, Q, lam)
        R, t = _pr_system(hf, M, m, r, 0)
        gf = _reg_solve(R, t, Q, lam)
    return hf, gf, 0


def pr_error_db(hf, gf, M: int, m: int, r: int, delay: int = 0) -> float:
    """Relative PR residual in dB: 20·log10(||R gf - t|| / ||t||)."""
    R, t = _pr_system(hf, M, m, r, delay)
    return 20.0 * np.log10(np.linalg.norm(R @ gf - t) / np.linalg.norm(t) + 1e-300)


@functools.lru_cache(maxsize=32)
def get_prototypes(cfg: FilterbankConfig) -> tuple[np.ndarray, np.ndarray, int]:
    """Designed (hf, gf, delay) for a config: the shipped `.npz` file where
    there is one, else `design_prototypes` with the config's `joint_iters`
    and `rolloff` (seconds of host time at M = 512).

    The arrays are cached and shared between callers: do not write to them.
    """
    key = f"proto-M{cfg.M}-m{cfg.m}-r{cfg.r}-b{cfg.rolloff:g}-j{cfg.joint_iters}.npz"
    path = PROTOTYPE_DIR / key
    if not path.exists():
        return design_prototypes(cfg.M, cfg.m, cfg.r, joint_iters=cfg.joint_iters,
                                 rolloff=cfg.rolloff)
    with np.load(path) as z:
        return z["hf"], z["gf"], int(z["delay"])
