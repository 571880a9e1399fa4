"""Fixed-weight subband beamformers: delay-and-sum and superdirective MVDR.

Counterpart of the fixed-weight part of `dsr_tpu/ops/beamforming.py`
(steering, DS, diffuse coherence, MVDR, apply).  Weights are batched over
the K subband bins and kept in complex64, with the JAX package's layouts:
steering vectors and weights (..., K, N), subbands (..., N, T, K).  The GSC
beamformers and `blocking_matrix` come with the GSC kernel (ROADMAP).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def subband_freqs(M: int, sample_rate: float, device=None) -> torch.Tensor:
    return torch.arange(M // 2 + 1, device=device, dtype=torch.float32) * (sample_rate / M)


def steering_vectors(taus_sec: torch.Tensor, M: int, sample_rate: float) -> torch.Tensor:
    """Array manifold: (..., N) delays (sec) → (..., K, N) complex64."""
    taus = torch.as_tensor(taus_sec, dtype=torch.float32)
    f = subband_freqs(M, sample_rate, taus.device)
    phase = -2.0 * math.pi * f[:, None] * taus[..., None, :]
    return torch.complex(torch.cos(phase), torch.sin(phase))


def ds_weights(v: torch.Tensor) -> torch.Tensor:
    """Delay-and-sum: w = v / N (distortionless)."""
    return v / v.shape[-1]


def diffuse_coherence(mic_positions: np.ndarray, M: int, sample_rate: float,
                      sound_speed: float, device=None) -> torch.Tensor:
    """Γ_ij(f_k) = sinc(2π f d_ij / c)  → (K, N, N) float32."""
    p = torch.as_tensor(np.asarray(mic_positions, np.float32), device=device)
    d = torch.linalg.norm(p[:, None, :] - p[None, :, :], dim=-1)
    f = subband_freqs(M, sample_rate, p.device)
    x = 2.0 * math.pi * f[:, None, None] * d[None] / sound_speed
    safe = torch.where(x == 0, torch.ones_like(x), x)
    return torch.where(x == 0, torch.ones_like(x), torch.sin(x) / safe)


def _loaded(Gamma: torch.Tensor, loading: float) -> torch.Tensor:
    N = Gamma.shape[-1]
    eye = torch.eye(N, dtype=Gamma.dtype, device=Gamma.device)
    return (Gamma + loading * eye).to(torch.complex64)


def mvdr_weights(v: torch.Tensor, Gamma: torch.Tensor, loading: float = 1e-2) -> torch.Tensor:
    """Superdirective MVDR, batched over bins: w = Γl⁻¹v / (vᴴΓl⁻¹v)."""
    gv = torch.linalg.solve(_loaded(Gamma, loading), v[..., None])[..., 0]
    denom = torch.sum(v.conj() * gv, dim=-1, keepdim=True)
    return gv / denom


def mvdr_precompute(Gamma: torch.Tensor, loading: float = 1e-2) -> torch.Tensor:
    """Γl⁻¹ per bin: depends on the geometry only, so it is computed once
    and steering updates cost one batched matvec (`mvdr_weights_from_inv`)."""
    return torch.linalg.inv(_loaded(Gamma, loading))


def mvdr_weights_from_inv(v: torch.Tensor, Gamma_inv: torch.Tensor) -> torch.Tensor:
    """w = Γl⁻¹v / (vᴴΓl⁻¹v) from the precomputed inverse."""
    gv = torch.einsum("...knm,...km->...kn", Gamma_inv, v)
    denom = torch.sum(v.conj() * gv, dim=-1, keepdim=True)
    return gv / denom


def apply_weights(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., t, k] = w_kᴴ X[..., :, t, k].  X: (..., N, T, K), w: (..., K, N)."""
    return torch.einsum("...kn,...ntk->...tk", w.conj(), X)


def ds_beamform(X: torch.Tensor, taus_sec: torch.Tensor, M: int,
                sample_rate: float) -> torch.Tensor:
    """Steering + delay-and-sum: X (N, T, K) complex, taus (N,) static or
    (T, N) per-frame trajectory → (T, K)."""
    taus = torch.as_tensor(taus_sec, dtype=torch.float32, device=X.device)
    v = steering_vectors(taus, M, sample_rate)
    if taus.ndim == 1:
        return apply_weights(X, ds_weights(v))
    return torch.einsum("tkn,ntk->tk", v.conj(), X) / X.shape[0]
