"""Post-beamformer enhancement: Zelinski, McCowan and Lefkimmiatis Wiener
post-filters, binary masks and APAB (PyTorch).

Counterpart of `dsr_tpu/ops/postfilter.py`.  Pair sums collapse to closed
forms where possible, Σ_{i<j} Re(X_i X_j*) = ½(|Σ_i X_i|² − Σ_i |X_i|²);
the recursive PSD smoothing is a loop over frames; everything else is
batched over (T, K).  Subbands (N, T, K) complex, gains (T, K) float32.
"""

from __future__ import annotations

import numpy as np
import torch


def smooth(vals: torch.Tensor, alpha: float) -> torch.Tensor:
    """First-order recursive smoothing along axis 0 (frames)."""
    out = torch.empty_like(vals)
    acc = vals[0]
    out[0] = acc
    for t in range(1, vals.shape[0]):
        acc = alpha * acc + (1 - alpha) * vals[t]
        out[t] = acc
    return out


def _smooth_ch(vals: torch.Tensor, alpha: float) -> torch.Tensor:
    """`smooth` of each channel of (C, T, K) along its frames."""
    return smooth(vals.transpose(0, 1), alpha).transpose(0, 1)


def zelinski_weights(X: torch.Tensor, alpha: float = 0.8, floor: float = 0.1) -> torch.Tensor:
    """X: (N, T, K) → gain (T, K)."""
    N = X.shape[0]
    p = X.abs() ** 2
    auto_inst = p.mean(dim=0)
    cross_inst = 0.5 * (X.sum(dim=0).abs() ** 2 - p.sum(dim=0))
    auto = smooth(auto_inst, alpha)
    cross = smooth(cross_inst / (N * (N - 1) / 2), alpha)
    return torch.clamp(cross / torch.clamp(auto, min=1e-12), floor, 1.0)


def _speech_psd(X: torch.Tensor, Gamma: torch.Tensor, alpha: float):
    """McCowan's per-pair speech PSD estimate (P, T, K) and the smoothed
    per-channel auto PSDs (N, T, K)."""
    ii, jj = np.triu_indices(X.shape[0], k=1)
    phi_auto = _smooth_ch(X.abs() ** 2, alpha)
    phi_ij = _smooth_ch((X[ii] * X[jj].conj()).real, alpha)
    g = torch.clamp(Gamma[:, ii, jj].real.T, -0.99, 0.99)[:, None, :]   # (P, 1, K)
    num = (phi_ij - 0.5 * g * (phi_auto[ii] + phi_auto[jj])) / (1.0 - g)
    return num, phi_auto


def mccowan_weights(X: torch.Tensor, Gamma: torch.Tensor, alpha: float = 0.8,
                    floor: float = 0.1) -> torch.Tensor:
    """X: (N, T, K); Gamma: (K, N, N) → gain (T, K)."""
    num, phi_auto = _speech_psd(X, Gamma, alpha)
    H = num.mean(dim=0) / torch.clamp(phi_auto.mean(dim=0), min=1e-12)
    return torch.clamp(H, floor, 1.0)


def binary_mask(Y_target: torch.Tensor, Y_ref: torch.Tensor, floor: float = 0.05) -> torch.Tensor:
    mask = (Y_target.abs() >= Y_ref.abs()).to(torch.float32)
    return torch.clamp(mask, min=floor)


def apab_weights(Y: torch.Tensor, Z: torch.Tensor, alpha: float = 0.8,
                 floor: float = 0.1) -> torch.Tensor:
    phi_y = smooth(Y.abs() ** 2, alpha)
    phi_z = smooth(Z.abs() ** 2, alpha)
    return torch.clamp(1.0 - phi_z / torch.clamp(phi_y, min=1e-12), floor, 1.0)


def apply_postfilter(Y: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    return Y * H.to(Y.real.dtype)


def lefkimmiatis_weights(X: torch.Tensor, Gamma: torch.Tensor, w: torch.Tensor,
                         alpha: float = 0.8, floor: float = 0.1) -> torch.Tensor:
    """Lefkimmiatis post-filter: McCowan's speech-PSD estimate with the
    Wiener gain formed from the diffuse-noise PSD at the beamformer output
    (wᴴΓw).  X: (N, T, K); Gamma: (K, N, N); w: (K, N) → gain (T, K)."""
    num, phi_auto = _speech_psd(X, Gamma, alpha)
    phi_ss = torch.clamp(num.mean(dim=0), min=0.0)
    phi_nn = torch.clamp(phi_auto.mean(dim=0) - phi_ss, min=0.0)
    wgw = torch.einsum("kn,knm,km->k", w.conj(), Gamma.to(w.dtype), w).real
    wgw = torch.clamp(wgw, min=1e-6)[None, :]
    H = phi_ss / torch.clamp(phi_ss + wgw * phi_nn, min=1e-12)
    return torch.clamp(H, floor, 1.0)
