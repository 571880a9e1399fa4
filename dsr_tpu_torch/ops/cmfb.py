"""Cosine-modulated filterbank (PyTorch).

Counterpart of `dsr_tpu/ops/cmfb.py`, with the port's copy of
`golden/cmfb.py`'s design (numpy): a near-perfect-reconstruction
pseudo-QMF bank of M real, critically sampled subbands, prototype length
L = 2·m·M, analysis/synthesis filters
    h_k[n] = 2 h[n] cos( (π/M)(k+½)(n − (L−1)/2) ± (−1)^k π/4 ),
a Kaiser prototype whose cutoff is bisected to |H(π/2M)| = 1/√2, and the
bank's delay and gain calibrated with an impulse at design time.

Analysis is one (T, L) × (L, M) matmul of the signal's hop views;
synthesis is a (T, M) × (M, L) matmul and `convolution.overlap_add_frames`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dsr_tpu_torch.ops.convolution import overlap_add_frames


@dataclass
class CmfbDesign:
    ha: np.ndarray   # (M, L) analysis filters
    hs: np.ndarray   # (M, L) synthesis filters
    M: int
    delay: int
    gain: float


def _prototype(M: int, m: int, beta: float) -> np.ndarray:
    L = 2 * m * M
    n = np.arange(L)
    c = (L - 1) / 2.0

    def proto(cut):
        h = np.sinc(cut * (n - c) / M) * np.kaiser(L, beta)
        return h / (h.sum() + 1e-30)

    lo, hi = 0.3, 0.7
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        h = proto(mid)
        H = np.abs(np.fft.rfft(h, 64 * L))
        w = np.linspace(0, np.pi, len(H))
        val = H[np.argmin(np.abs(w - np.pi / (2 * M)))] / H[0]
        if val > np.sqrt(0.5):
            hi = mid
        else:
            lo = mid
    return proto(0.5 * (lo + hi))


def _raw_analysis(x: np.ndarray, ha: np.ndarray, M: int) -> np.ndarray:
    Mb, L = ha.shape
    S = len(x)
    T = -(-(S + L) // M) + ha.shape[1] // M
    xp = np.concatenate([np.zeros(L - 1), x, np.zeros(T * M + L - S)])
    out = np.empty((T, Mb))
    rev = ha[:, ::-1]
    for t in range(T):
        out[t] = rev @ xp[t * M : t * M + L]
    return out


def _raw_synthesis(U: np.ndarray, hs: np.ndarray, M: int) -> np.ndarray:
    T, Mb = U.shape
    L = hs.shape[1]
    y = np.zeros((T - 1) * M + L)
    for t in range(T):
        y[t * M : t * M + L] += U[t] @ hs
    return y


def design(M: int, m: int = 8, beta: float = 9.0) -> CmfbDesign:
    h = _prototype(M, m, beta)
    L = len(h)
    n = np.arange(L)
    ks = np.arange(M)[:, None]
    phase = (np.pi / M) * (ks + 0.5) * (n[None, :] - (L - 1) / 2)
    theta = ((-1.0) ** ks) * (np.pi / 4)
    ha = 2 * h[None, :] * np.cos(phase + theta)
    hs = 2 * h[None, :] * np.cos(phase - theta)
    # calibrate delay & gain with an impulse
    imp = np.zeros(4 * L)
    imp[2 * L] = 1.0
    y = _raw_synthesis(_raw_analysis(imp, ha, M), hs, M)
    k = int(np.argmax(np.abs(y)))
    gain = y[k]
    # y index k corresponds to x index 2L: reconstruction delay in y-coords
    delay = k - 2 * L
    return CmfbDesign(ha, hs, M, delay, float(gain))


def analysis(x: torch.Tensor, d: CmfbDesign) -> torch.Tensor:
    """(..., S) → (..., T, M) real subbands, T = ceil((S + L) / M) + L / M."""
    M, L = d.M, d.ha.shape[1]
    S = x.shape[-1]
    T = -(-(S + L) // M) + L // M
    ha_rev = torch.as_tensor(np.ascontiguousarray(d.ha[:, ::-1].T), dtype=torch.float32,
                             device=x.device)                                   # (L, M)
    xp = torch.nn.functional.pad(x.to(torch.float32), (L - 1, T * M + L - S))
    return xp.unfold(-1, L, M)[..., :T, :] @ ha_rev


def synthesis(U: torch.Tensor, d: CmfbDesign, out_len: int) -> torch.Tensor:
    """(..., T, M) → (..., out_len) with the design's delay and gain compensated."""
    M, L = d.M, d.hs.shape[1]
    T = U.shape[-2]
    hs = torch.as_tensor(d.hs / d.gain, dtype=torch.float32, device=U.device)
    y = overlap_add_frames(U.to(torch.float32) @ hs, M)
    ylen = (T - 1) * M + L
    start = min(max(d.delay, 0), ylen - out_len)       # the JAX slice's clamp
    return y[..., start:start + out_len]
