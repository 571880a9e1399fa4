"""Learned neural beamformer (PyTorch): the mask-based MVDR front end of
config 5.

Counterpart of `dsr_tpu/models/neural_beamformer.py`: a small conv mask
estimator predicts per-bin speech and noise masks from the channels' mean
log-magnitude; the masked spatial covariances give time-invariant
Souden MVDR weights per utterance (one batched complex64
`torch.linalg.solve` over the bins).  Differentiable end to end: the CTC
loss reaches the mask estimator through the solve.  Every function takes
leading batch axes, which stand for the JAX package's `vmap`.
"""

from __future__ import annotations

import torch
from torch import nn

from dsr_tpu_torch.models.conformer import _generator, conv, conv_frames, dense
from dsr_tpu_torch.utils.device import resolve


class MaskEstimator(nn.Module):
    """(…, T, K) log-magnitudes → (speech mask, noise mask) in [0, 1]:
    Dense → ReLU → conv over frames (k 5, dilation 1) → ReLU → conv (k 5,
    dilation 2) → ReLU → one sigmoid Dense per mask.  `num_bins` = K
    (flax infers it from the first input)."""

    def __init__(self, num_bins: int, hidden: int = 128, *, device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        self.inp = dense(num_bins, hidden, device, g)
        # SAME, as flax pads a stride-1 kernel of 5: 2 frames each side
        # (4 at dilation 2)
        self.conv1 = conv(nn.Conv1d, hidden, hidden, 5, device, g, padding=2)
        self.conv2 = conv(nn.Conv1d, hidden, hidden, 5, device, g, padding=4, dilation=2)
        self.speech = dense(hidden, num_bins, device, g)
        self.noise = dense(hidden, num_bins, device, g)

    def forward(self, logmag):
        h = torch.relu(self.inp(logmag))
        h = torch.relu(conv_frames(self.conv1, h))
        h = torch.relu(conv_frames(self.conv2, h))
        return torch.sigmoid(self.speech(h)), torch.sigmoid(self.noise(h))


def masked_psd(X: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """X (…, N, T, K) complex, mask (…, T, K) → Φ (…, K, N, N), the
    mask-weighted spatial covariance Σ_t m x xᴴ / (Σ_t m + eps)."""
    num = torch.einsum("...tk,...ntk,...mtk->...knm", mask.to(X.dtype), X, X.conj())
    den = mask.sum(dim=-2)[..., None, None] + eps
    return num / den


def load_diagonal(phi_n: torch.Tensor, loading: float = 1e-4) -> torch.Tensor:
    """Φn + loading · tr(Φn)/N · I: the noise PSD that the MVDR solve takes."""
    N = phi_n.shape[-1]
    eye = torch.eye(N, dtype=phi_n.dtype, device=phi_n.device)
    tr_load = phi_n.real.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return phi_n + loading * (tr_load / N) * eye


def loaded_condition(phi_n: torch.Tensor, loading: float = 1e-4) -> torch.Tensor:
    """The 2-norm condition number of each loaded Φn (…, K), taken in
    complex128: float32 rounding of Φ moves the MVDR weights by up to about
    this many times itself."""
    return torch.linalg.cond(load_diagonal(phi_n.detach().to(torch.complex128), loading))


def mvdr_from_psds(phi_s: torch.Tensor, phi_n: torch.Tensor, ref: int = 0,
                   loading: float = 1e-4) -> torch.Tensor:
    """Souden MVDR: w = (Φn⁻¹Φs / tr(Φn⁻¹Φs)) e_ref, conjugated as the JAX
    package returns it, (…, K, N); Φn's diagonal loaded by loading · tr(Φn)/N.
    A singular Φn (a noise mask of exact zeros in a bin) gives non-finite
    weights, as `jnp.linalg.solve` does, where `torch.linalg.solve` would
    raise (and read its status back from the card every call)."""
    nume, _ = torch.linalg.solve_ex(load_diagonal(phi_n, loading), phi_s)
    tr = nume.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None]
    return (nume[..., ref] / (tr + 1e-8)).conj_physical()


class NeuralBeamformer(nn.Module):
    """Multichannel subbands (…, N, T, K) → enhanced subbands (…, T, K)."""

    def __init__(self, num_bins: int, hidden: int = 128, *, device=None, generator=None):
        super().__init__()
        self.mask = MaskEstimator(num_bins, hidden, device=device, generator=generator)

    def forward(self, X):
        logmag = torch.log(X.abs().mean(dim=-3) + 1e-6)
        ms, mn = self.mask(logmag)
        w = mvdr_from_psds(masked_psd(X, ms), masked_psd(X, mn))
        return torch.einsum("...kn,...ntk->...tk", w.conj(), X)
