"""Blocks of far-field multichannel audio for the front end: one talker
per block at its own position, free field, on the configuration's array.

A block is `block_s` seconds at the array's rate.  Its talker is white
Gaussian noise, delayed to each microphone by the point-source delay
(|p_n - s| - |s|) / c, applied as a phase ramp on the block's spectrum
(circular, so the block's ends wrap), plus independent sensor noise at
`snr_db`.  The talker stands `distance_m` [min, max] from the array's
centre at a uniform azimuth and at a height `height_m` [min, max].
Every block has the same size, so every seed gives the same work.

Params (`traffic/<mix>.json`): `block_s`, `pool_blocks`, `group`,
`ahead`, `distance_m`, `height_m`, `snr_db`.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def circular_array(n: int, radius: float) -> np.ndarray:
    """(n, 3) microphone positions on a horizontal circle about the origin."""
    a = 2 * math.pi * np.arange(n) / n
    return np.stack([radius * np.cos(a), radius * np.sin(a), np.zeros(n)], axis=1)


def array_positions(array: dict) -> np.ndarray:
    if array["kind"] != "circular":
        raise ValueError(f"unknown array kind {array['kind']!r}")
    return circular_array(array["channels"], array["radius_m"])


def talkers(p: dict, rng) -> np.ndarray:
    """(pool_blocks, 3) talker positions."""
    n = p["pool_blocks"]
    az = rng.uniform(0, 2 * math.pi, n)
    dist = rng.uniform(*p["distance_m"], n)
    z = rng.uniform(*p["height_m"], n)
    horiz = np.sqrt(np.maximum(dist**2 - z**2, 0.0))
    return np.stack([horiz * np.cos(az), horiz * np.sin(az), z], axis=1)


def delays_s(mics: np.ndarray, src: np.ndarray, c: float) -> np.ndarray:
    """(B, N) point-source delays in seconds, relative to the array origin."""
    d = np.linalg.norm(mics[None, :, :] - src[:, None, :], axis=-1)
    return (d - np.linalg.norm(src, axis=-1)[:, None]) / c


def make_pool(config: dict, p: dict, seed: int, device):
    """(bank (B, N, S) float32 on the device, talker positions (B, 3))."""
    rng = np.random.default_rng(seed)
    fs = config["sample_rate"]
    mics = array_positions(config["array"])
    pos = talkers(p, rng)
    tau = torch.as_tensor(delays_s(mics, pos, config["array"]["sound_speed"]), device=device)
    S = int(round(p["block_s"] * fs))
    B, N = len(pos), len(mics)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    sigma = 10 ** (-p["snr_db"] / 20)
    f = torch.fft.rfftfreq(S, 1.0 / fs, device=device, dtype=torch.float64)
    bank = torch.empty((B, N, S), dtype=torch.float32, device=device)
    for b in range(B):
        s = torch.fft.rfft(torch.randn(S, generator=gen, device=device))
        phase = -2 * math.pi * f[None, :] * tau[b, :, None]
        ramp = torch.complex(torch.cos(phase), torch.sin(phase)).to(torch.complex64)
        bank[b] = torch.fft.irfft(s[None, :] * ramp, n=S)
        bank[b] += sigma * torch.randn((N, S), generator=gen, device=device)
    return bank, pos
