"""Subband acoustic echo cancellation (NLMS, Kalman) and voice-prompt
cancellation for barge-in (PyTorch).

Counterpart of `dsr_tpu/ops/aec.py`.  Each filter is a recurrence over
frames, run as a Python loop of complex64 ops on the (K, taps) state of
every subband at once, on the device of its input, as the JAX scan's body
does.  The far-end history of a frame, [F[t], F[t-1], ..., F[t-taps+1]]
(the scan's `roll` and `set`), depends on the input alone, so it and the
quantities made from it alone are formed for all frames before the loop.
"""

from __future__ import annotations

import torch


def _history(F: torch.Tensor, taps: int) -> torch.Tensor:
    """(T, K) → (T, K, taps): hist[t, :, j] = F[t - j], zero before frame 0."""
    Fp = torch.cat([F.new_zeros(taps - 1, F.shape[1]), F], dim=0)
    return Fp.unfold(0, taps, 1).flip(-1)


def nlms_aec(D: torch.Tensor, F: torch.Tensor, taps: int = 4, mu: float = 0.5,
             eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """D (mic), F (far end): (T, K) complex → (E (T, K), W (K, taps)) complex64."""
    D, F = D.to(torch.complex64), F.to(torch.complex64)
    hist = _history(F, taps)
    mu_hist = mu * hist
    norm = ((hist.abs() ** 2).sum(-1) + eps)[..., None]          # (T, K, 1)
    W = D.new_zeros(D.shape[1], taps)
    E = []
    for t in range(D.shape[0]):
        e = D[t] - (W.conj() * hist[t]).sum(-1)
        W = W + mu_hist[t] * e.conj()[:, None] / norm[t]
        E.append(e)
    return torch.stack(E), W


def kalman_aec(D: torch.Tensor, F: torch.Tensor, taps: int = 4, q: float = 1e-4,
               r0: float = 1e-2) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagonal-covariance per-subband Kalman AEC: (T, K) complex →
    (E (T, K), W (K, taps)).  P is float32, W and the history complex64."""
    D, F = D.to(torch.complex64), F.to(torch.complex64)
    hist = _history(F, taps)
    pow_hist = hist.abs() ** 2                                     # (T, K, taps) float32
    W = D.new_zeros(D.shape[1], taps)
    P = torch.full((D.shape[1], taps), 0.1, dtype=torch.float32, device=D.device)
    E = []
    for t in range(D.shape[0]):
        P = P + q
        e = D[t] - (W.conj() * hist[t]).sum(-1)
        S = (P * pow_hist[t]).sum(-1, keepdim=True) + r0              # (K, 1)
        W = W + P * hist[t] / S.to(torch.complex64) * e.conj()[:, None]
        P = torch.clamp_min(P * (1.0 - P * pow_hist[t] / S), 1e-8)
        E.append(e)
    return torch.stack(E), W


def cancel_voice_prompt(D: torch.Tensor, prompt_subbands: torch.Tensor, taps: int = 4,
                        mu: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """Barge-in: cancel the known playback prompt from the mic signal
    (reference `btk/cancelVP/`): NLMS with the prompt as the far end."""
    return nlms_aec(D, prompt_subbands, taps=taps, mu=mu)
