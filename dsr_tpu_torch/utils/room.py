"""Synthetic multi-channel room simulator (numpy only).

The port's copy of `golden/room.py`, bit for bit, so that the port can
make reverberant array recordings (the triphone training of
`chip_smoke.py`) without the reference's oracles.  Two models:

  - anechoic point source with exact fractional delays per microphone
    (frequency-domain delay) — `simulate` with `room_dim=None`;
  - Allen–Berkley image-source shoebox reverberation — `simulate` with
    `room_dim`/`reflect`/`max_order` set (`image_sources` enumerates the
    images; each contributes a 1/r-attenuated, wall-absorbed fractional
    delay rendered in the frequency domain).

Both add independent sensor noise and optional diffuse (spherically
isotropic) noise.  All arrays are float64 NumPy, deterministic given an
rng.  `steering_delays` is `utils.design`'s.
"""

from __future__ import annotations

import numpy as np

from dsr_tpu_torch.utils.design import steering_delays

__all__ = ["frac_delay", "steering_delays", "image_sources", "simulate"]


def frac_delay(x: np.ndarray, delay_samples: float) -> np.ndarray:
    """Delay x by a (possibly fractional) number of samples, FFT method."""
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    X = np.fft.rfft(x, nfft)
    f = np.arange(len(X)) / nfft  # cycles/sample
    y = np.fft.irfft(X * np.exp(-2j * np.pi * f * delay_samples), nfft)
    return y[:n]


def image_sources(
    source_abs: np.ndarray, room_dim: np.ndarray, max_order: int,
    reflect: float | np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Allen–Berkley shoebox images of a source at `source_abs` (room
    coordinates, walls at 0 and `room_dim` per axis).

    Image coordinates are ``(-1)^p s + 2 r L`` for p ∈ {0,1}^3, r ∈ Z^3;
    the image's amplitude is ``Π_a β0_a^|r_a - p_a| · β1_a^|r_a|`` (β0 the
    wall at 0, β1 the wall at L).  `reflect` is a scalar β for all six
    walls or a (6,) array (x0, x1, y0, y1, z0, z1).  Only images with total
    reflection count ≤ `max_order` are returned.

    → (positions (P, 3), amplitudes (P,)); P = 1 (the source itself) when
    max_order == 0.
    """
    s = np.asarray(source_abs, np.float64)
    L = np.asarray(room_dim, np.float64)
    betas = np.broadcast_to(np.asarray(reflect, np.float64), (6,)).reshape(3, 2)
    R = int(max_order)
    ns = np.arange(-((R + 1) // 2), (R + 1) // 2 + 1)
    pos, amp = [], []
    for px in (0, 1):
        for py in (0, 1):
            for pz in (0, 1):
                p = np.array([px, py, pz])
                for nx in ns:
                    for ny in ns:
                        for nz in ns:
                            r = np.array([nx, ny, nz])
                            hits0 = np.abs(r - p)     # wall at 0 per axis
                            hits1 = np.abs(r)         # wall at L per axis
                            if hits0.sum() + hits1.sum() > R:
                                continue
                            pos.append((1 - 2 * p) * s + 2 * r * L)
                            amp.append(
                                np.prod(betas[:, 0] ** hits0)
                                * np.prod(betas[:, 1] ** hits1)
                            )
    return np.asarray(pos), np.asarray(amp)


def simulate(
    source: np.ndarray,
    mic_positions: np.ndarray,
    source_pos: np.ndarray,
    sample_rate: float = 16000.0,
    sound_speed: float = 343.0,
    snr_db: float | None = 20.0,
    diffuse_snr_db: float | None = None,
    rng: np.random.Generator | None = None,
    room_dim: np.ndarray | None = None,
    array_center: np.ndarray | None = None,
    reflect: float | np.ndarray = 0.0,
    max_order: int = 0,
) -> np.ndarray:
    """Render `source` at `source_pos` onto an array.  → (N, S) float64.

    snr_db: per-channel white sensor noise SNR.  diffuse_snr_db: optional
    spherically-diffuse noise built by averaging many far-field white plane
    waves (used by MVDR tests, since Γ_diffuse is its noise model).

    Reverberation (image-source model): pass `room_dim` (Lx, Ly, Lz) to
    place the scene in a shoebox room; `array_center` positions the array
    origin in room coordinates (mic/source positions stay relative to the
    array origin, so `steering_delays` remains valid for the direct path);
    `reflect` is the wall amplitude reflection β (scalar or (6,));
    `max_order` the highest reflection order rendered.  Gains carry 1/r
    attenuation normalised so the direct path at the array center has unit
    gain, and arrivals are timed relative to the direct path at the array
    center (matching the anechoic convention).  With `room_dim=None` the
    model is exactly the anechoic point source.
    """
    rng = np.random.default_rng(0) if rng is None else rng
    N = len(mic_positions)
    S = len(source)
    if room_dim is None:
        taus = steering_delays(mic_positions, source_pos, sound_speed, sample_rate)
        out = np.stack([frac_delay(source, t) for t in taus])
    else:
        center = (np.asarray(room_dim, np.float64) / 2.0
                  if array_center is None else np.asarray(array_center, np.float64))
        src_abs = center + np.asarray(source_pos, np.float64)
        mics_abs = center + np.asarray(mic_positions, np.float64)
        imgs, amps = image_sources(src_abs, room_dim, max_order, reflect)
        d0 = np.linalg.norm(src_abs - center)           # direct @ array center
        # one rfft of the source; per mic, sum image gains x phase ramps
        nfft = 1 << int(np.ceil(np.log2(2 * S)))
        X = np.fft.rfft(source, nfft)
        f = np.arange(len(X)) / nfft                    # cycles/sample
        out = np.empty((N, S))
        for i in range(N):
            d = np.linalg.norm(imgs - mics_abs[i][None, :], axis=1)  # (P,)
            gains = amps * (d0 / np.maximum(d, 1e-6))
            delays = (d - d0) / sound_speed * sample_rate
            H = (gains[:, None] * np.exp(-2j * np.pi * f[None, :] * delays[:, None])
                 ).sum(axis=0)
            out[i] = np.fft.irfft(X * H, nfft)[:S]
    sig_pow = np.mean(source**2) + 1e-30
    if diffuse_snr_db is not None:
        diff = np.zeros((N, S))
        n_dirs = 64
        dirs = _fibonacci_sphere(n_dirs)
        for u in dirs:
            w = rng.standard_normal(S)
            dl = -(mic_positions @ u) / sound_speed * sample_rate
            for i in range(N):
                diff[i] += frac_delay(w, dl[i])
        diff *= np.sqrt(sig_pow / np.mean(diff**2) * 10 ** (-diffuse_snr_db / 10))
        out = out + diff
    if snr_db is not None:
        noise = rng.standard_normal((N, S))
        noise *= np.sqrt(sig_pow * 10 ** (-snr_db / 10))
        out = out + noise
    return out


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1
    )
