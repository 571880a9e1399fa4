"""LPC, warped-LPC and (warped-)MVDR spectral envelopes and cepstra (PyTorch).

Counterpart of `dsr_tpu/ops/lpc.py` (the Wölfel warped-MVDR front end),
batched over frames and run where the frames lie:

  - `autocorr`: the biased autocorrelation by an rFFT (Wiener-Khinchin);
  - `warped_autocorr`: each stage of the first-order allpass chain
    D(z) = (z^-1 - λ) / (1 - λ z^-1) is a fixed linear map of the whole
    frame, y_i = y_{i-1} Hᵀ with H the n × n lower-triangular Toeplitz
    matrix of D's impulse response, so the chain is `order` float32
    matmuls of (frames, n) × (n, n) rather than a loop over samples;
  - `levinson`: Levinson-Durbin, a Python loop over the order of vector
    ops batched over frames;
  - `lpc_envelope` / `mvdr_envelope`: (frames, order) × (order, bins)
    matmuls; `warped_mvdr_cepstra` chains them with the log and a DCT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dsr_tpu_torch.utils.design import dct_matrix


def autocorr(x: torch.Tensor, order: int) -> torch.Tensor:
    """Biased autocorrelation r[0..order] via FFT.  x: (..., n)."""
    n = x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    X = torch.fft.rfft(x, nfft, dim=-1)
    r = torch.fft.irfft((X.abs() ** 2).to(X.dtype), nfft, dim=-1)[..., :order + 1]
    return r / n


@functools.lru_cache(maxsize=16)
def _allpass_matrix(n: int, lam: float, device: torch.device) -> torch.Tensor:
    """Hᵀ (n, n) float32: y Hᵀ filters each row y through D(z), zero state.
    D's impulse response is h[0] = -λ, h[k] = (1 - λ²) λ^(k-1)."""
    h = np.empty(n)
    h[0] = -lam
    h[1:] = (1.0 - lam * lam) * lam ** np.arange(n - 1)
    k = np.arange(n)
    lag = k[None, :] - k[:, None]                  # Hᵀ[s, t] = h[t - s], t >= s
    HT = np.where(lag >= 0, h[np.maximum(lag, 0)], 0.0)
    return torch.as_tensor(HT.astype(np.float32), device=device)


def warped_autocorr(x: torch.Tensor, order: int, lam: float = 0.4595) -> torch.Tensor:
    """Warped autocorrelation r̃[i] = <x, D^i x> / n, i = 0..order.
    x: (..., n) → (..., order+1)."""
    n = x.shape[-1]
    xb = x.reshape(-1, n)
    HT = _allpass_matrix(n, float(lam), x.device)
    ys = [xb]
    for _ in range(order):
        ys.append(ys[-1] @ HT)
    r = (torch.stack(ys, dim=1) * xb[:, None, :]).sum(-1) / n
    return r.reshape(*x.shape[:-1], order + 1)


def levinson(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin, batched: r (..., p+1) → (a (..., p), err (...,))."""
    p = r.shape[-1] - 1
    a = r.new_zeros(*r.shape[:-1], p)
    err = r[..., 0]
    for i in range(1, p + 1):
        # acc = r[i] - sum_{j<i-1} a[j] r[i-1-j]
        acc = r[..., i] - (a[..., :i - 1] * r[..., 1:i].flip(-1)).sum(-1)
        k = torch.where(err > 0, acc / err.clamp_min(1e-30), 0.0)
        # a_new[j] = a[j] - k a[i-2-j] for j < i-1;  a_new[i-1] = k
        a_new = a.clone()
        a_new[..., :i - 1] = a[..., :i - 1] - k[..., None] * a[..., :i - 1].flip(-1)
        a_new[..., i - 1] = k
        a = a_new
        err = err * (1.0 - k * k)
    return a, err.clamp_min(1e-20)


@functools.lru_cache(maxsize=16)
def _lpc_phasors(p: int, num_bins: int, device: torch.device) -> torch.Tensor:
    w = np.linspace(0, np.pi, num_bins)
    ph = np.exp(-1j * w[:, None] * np.arange(p + 1)[None, :])        # (bins, p+1)
    return torch.as_tensor(ph.T.astype(np.complex64), device=device)


def _poly(a: torch.Tensor) -> torch.Tensor:
    """b = [1, -a_1, ..., -a_p]."""
    return torch.cat([torch.ones_like(a[..., :1]), -a], dim=-1)


def lpc_envelope(a: torch.Tensor, err: torch.Tensor, num_bins: int) -> torch.Tensor:
    """All-pole spectrum on uniform ω ∈ [0, π].  a: (..., p) → (..., num_bins)."""
    A = _poly(a).to(torch.complex64) @ _lpc_phasors(a.shape[-1], num_bins, a.device)
    return err[..., None] / torch.clamp_min(A.abs() ** 2, 1e-20)


@functools.lru_cache(maxsize=16)
def _mvdr_tables(p: int, num_bins: int, device: torch.device):
    """The Musicus weights (k, i), the shifted index i + k and the cosine
    matrix (p+1, bins) of `mvdr_envelope`."""
    i = np.arange(p + 1)
    k = np.arange(p + 1)
    wgt = (p + 1 - k[:, None] - 2 * i[None, :]).astype(np.float32)
    valid = (i[None, :] <= p - k[:, None]).astype(np.float32)
    idx = np.minimum(i[None, :] + k[:, None], p)                     # clamped, masked anyway
    w = np.linspace(0, np.pi, num_bins)
    cos = np.cos(w[:, None] * k[None, :]).astype(np.float32)         # (bins, p+1)
    cos[:, 1:] *= 2.0
    return (torch.as_tensor(wgt * valid, device=device), torch.as_tensor(idx, device=device),
            torch.as_tensor(np.ascontiguousarray(cos.T), device=device))


def mvdr_envelope(a: torch.Tensor, err: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Musicus MVDR envelope, batched.  a: (..., p) → (..., num_bins).
    μ[k] = Σ_i (p+1-k-2i) b[i] b[i+k], 0 <= i <= p-k;  S(ω) = Σ_k μ_k e^{-jωk}."""
    wv, idx, cosT = _mvdr_tables(a.shape[-1], num_bins, a.device)
    b = _poly(a)
    bb = b[..., None, :] * b[..., idx]                               # (..., k, i)
    mu = (bb * wv).sum(-1)                                           # (..., p+1)
    return err[..., None] / torch.clamp_min(mu @ cosT, 1e-20)


@functools.lru_cache(maxsize=16)
def _dct(num_cepstra: int, num_bins: int, device: torch.device) -> torch.Tensor:
    C = dct_matrix(num_cepstra, num_bins).astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(C.T), device=device)


def warped_mvdr_cepstra(
    frames: torch.Tensor,
    order: int = 30,
    lam: float = 0.4595,
    num_bins: int = 129,
    num_cepstra: int = 13,
) -> torch.Tensor:
    """Batched warped-MVDR cepstra: (..., T, n) frames → (..., T, num_cepstra)."""
    r = warped_autocorr(frames, order, lam)
    a, err = levinson(r)
    env = mvdr_envelope(a, err, num_bins)
    return torch.log(torch.clamp_min(env, 1e-20)) @ _dct(num_cepstra, num_bins, frames.device)
