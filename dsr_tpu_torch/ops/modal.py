"""Modal (spherical-harmonic) eigenbeamformer for spherical arrays.

Counterpart of `dsr_tpu/ops/modal.py` and a numpy rewrite of
`golden/modal.py`, which uses scipy: the weights are designed on the host
(`sh_matrix`, `bn_open_sphere`, `modal_weights`, `plane_wave_pressure`),
and applied with `beamforming.apply_weights` like every other subband
beamformer.

Open-sphere model: a unit plane wave from direction Ω₀ gives mic signals
    p(Ω_q) = Σ_{n=0}^{N} b_n(ka) Σ_m Y_n^m(Ω_q) Y_n^m*(Ω₀),
    b_n(ka) = 4π iⁿ j_n(ka).
The beamformer decomposes the mics into SH coefficients (pseudo-inverse
of the SH matrix), equalises by 1/b_n (regularised) and steers with
Y_n^m*(Ω_look).

Y_n^m(θ, φ) follows scipy's `sph_harm_y`: θ the colatitude, φ the
azimuth, the Condon–Shortley phase inside P_n^m, and
Y_n^{-m} = (-1)^m conj(Y_n^m).  The spherical Bessel function j_n is a
power series below x = n + 1, where the upward recurrence from j_0 and
j_1 loses its digits, and that recurrence above.
"""

from __future__ import annotations

import math

import numpy as np


def _legendre(n: int, m: int, x: np.ndarray) -> np.ndarray:
    """Associated Legendre P_n^m(x), 0 <= m <= n, with the Condon–Shortley phase."""
    pmm = np.ones_like(x)
    if m > 0:
        s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
        for k in range(1, m + 1):
            pmm = -pmm * (2 * k - 1) * s
    if n == m:
        return pmm
    p_prev, p = pmm, x * (2 * m + 1) * pmm
    for ell in range(m + 2, n + 1):
        p_prev, p = p, ((2 * ell - 1) * x * p - (ell + m - 1) * p_prev) / (ell - m)
    return p


def sph_harm(n: int, m: int, theta: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Y_n^m(θ colatitude, φ azimuth), scipy's `sph_harm_y(n, m, θ, φ)`."""
    theta, phi = np.asarray(theta, np.float64), np.asarray(phi, np.float64)
    am = abs(m)
    norm = math.sqrt((2 * n + 1) / (4 * math.pi) * math.factorial(n - am)
                     / math.factorial(n + am))
    y = norm * _legendre(n, am, np.cos(theta)) * np.exp(1j * am * phi)
    return (-1) ** am * np.conj(y) if m < 0 else y


def spherical_jn(n: int, x) -> np.ndarray:
    """Spherical Bessel function of the first kind j_n(x), x >= 0."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    out = np.empty_like(x)
    small = x < n + 1
    xs = x[small]
    if xs.size:
        # j_n(x) = x^n / (2n+1)!! Σ_k (-x²/2)^k / (k! (2n+3)(2n+5)...(2n+2k+1))
        lead = xs ** n / math.prod(range(1, 2 * n + 2, 2))
        term = np.ones_like(xs)
        acc = np.ones_like(xs)
        for k in range(1, 200):
            term = term * (-0.5 * xs * xs) / (k * (2 * n + 2 * k + 1))
            acc = acc + term
            if np.all(np.abs(term) <= 1e-17 * np.abs(acc)):
                break
        out[small] = lead * acc
    xl = x[~small]
    if xl.size:
        j0 = np.sin(xl) / xl
        j1 = np.sin(xl) / (xl * xl) - np.cos(xl) / xl
        jp, j = j0, j1
        if n == 0:
            j = j0
        for ell in range(1, n):
            jp, j = j, (2 * ell + 1) / xl * j - jp
        out[~small] = j
    return out


def sh_matrix(order: int, thetas: np.ndarray, phis: np.ndarray) -> np.ndarray:
    """Y: (Q, (order+1)²) complex SH values at mic directions (colat, az)."""
    cols = []
    for n in range(order + 1):
        for m in range(-n, n + 1):
            cols.append(sph_harm(n, m, thetas, phis))
    return np.stack(cols, axis=1)


def bn_open_sphere(order: int, ka: float) -> np.ndarray:
    """Modal strengths b_n(ka) repeated per m → ((order+1)²,) complex."""
    out = []
    for n in range(order + 1):
        bn = 4 * np.pi * (1j**n) * spherical_jn(n, ka)[0]
        out.extend([bn] * (2 * n + 1))
    return np.asarray(out)


def modal_weights(
    order: int,
    ka: float,
    mic_dirs: np.ndarray,   # (Q, 2) [colatitude, azimuth]
    look_dir: np.ndarray,   # (2,)
    reg: float = 1e-2,
) -> np.ndarray:
    """→ w (Q,) conj-weights: y = w^H p gives the plane-wave-domain output.

    Regularised modal equalisation (|b_n|² + reg) caps white-noise gain at
    high orders where j_n(ka) → 0.
    """
    Y = sh_matrix(order, mic_dirs[:, 0], mic_dirs[:, 1])          # (Q, NM)
    Ypinv = np.linalg.pinv(Y)                                      # (NM, Q)
    bn = bn_open_sphere(order, ka)
    eq = np.conj(bn) / (np.abs(bn) ** 2 + reg)
    y0 = sh_matrix(order, look_dir[:1], look_dir[1:2])[0]          # (NM,)
    # y = Σ_nm eq_nm Y*_nm(look) (Ypinv p)_nm = (stuff)ᴴ p
    w_h = (eq * np.conj(y0)) @ Ypinv                               # (Q,)
    return np.conj(w_h)


def plane_wave_pressure(order: int, ka: float, mic_dirs: np.ndarray,
                        src_dir: np.ndarray) -> np.ndarray:
    """Open-sphere plane-wave response at the mics (order-truncated)."""
    Y = sh_matrix(order, mic_dirs[:, 0], mic_dirs[:, 1])
    y0 = sh_matrix(order, src_dir[:1], src_dir[1:2])[0]
    bn = bn_open_sphere(order, ka)
    return Y @ (bn * np.conj(y0))


def modal_weights_subband(
    order: int,
    radius: float,
    M: int,
    sample_rate: float,
    mic_dirs: np.ndarray,
    look_dir: np.ndarray,
    sound_speed: float = 343.0,
    reg: float = 1e-2,
) -> np.ndarray:
    """Per-bin modal weights → (K, Q) complex64 for `beamforming.apply_weights`."""
    K = M // 2 + 1
    freqs = np.arange(K) * sample_rate / M
    W = np.zeros((K, len(mic_dirs)), np.complex64)
    for k, f in enumerate(freqs):
        ka = 2 * np.pi * f * radius / sound_speed
        if ka < 1e-6:
            W[k] = 1.0 / len(mic_dirs)
            continue
        W[k] = modal_weights(order, ka, mic_dirs, look_dir, reg)
    return W


def sphere_mic_dirs(n: int) -> np.ndarray:
    """Near-uniform (colatitude, azimuth) directions via a Fibonacci sphere."""
    i = np.arange(n) + 0.5
    colat = np.arccos(1 - 2 * i / n)
    az = (np.pi * (1 + 5**0.5) * i) % (2 * np.pi)
    return np.stack([colat, az], axis=1)
