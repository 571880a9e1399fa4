"""Subband beamformers: delay-and-sum, superdirective MVDR and the GSC
(NLMS, block-NLMS, RLS, maximum kurtosis).

Counterpart of `dsr_tpu/ops/beamforming.py`.  Weights are batched over the
K subband bins and kept in complex64, with the JAX package's layouts:
steering vectors and weights (..., K, N), subbands (..., N, T, K), blocking
matrices (..., K, N, N-1), GSC active weights (..., K, N-1).

Two functions launch hand-written kernels on CUDA tensors and run their
plain twins on CPU tensors: `ds_beamform` (fused steering + DS,
`ops/cuda/steering.py`) and `gsc_nlms` (the frame recurrence,
`ops/cuda/gsc.py`).  The other adaptive beamformers are plain PyTorch,
their frame recurrences Python loops, as the JAX package's are scans.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dsr_tpu_torch.ops.cuda import gsc as _gsc
from dsr_tpu_torch.ops.cuda import steering as _steer
from dsr_tpu_torch.utils import profiling


def subband_freqs(M: int, sample_rate: float, device=None) -> torch.Tensor:
    return torch.arange(M // 2 + 1, device=device, dtype=torch.float32) * (sample_rate / M)


def steering_vectors(taus_sec: torch.Tensor, M: int, sample_rate: float) -> torch.Tensor:
    """Array manifold: (..., N) delays (sec) → (..., K, N) complex64."""
    with profiling.scope("beamforming.steering_vectors"):
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
    with profiling.scope("beamforming.mvdr_weights"):
        gv = torch.einsum("...knm,...km->...kn", Gamma_inv, v)
        denom = torch.sum(v.conj() * gv, dim=-1, keepdim=True)
        return gv / denom


def apply_weights(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[..., t, k] = w_kᴴ X[..., :, t, k].  X: (..., N, T, K), w: (..., K, N)."""
    return torch.einsum("...kn,...ntk->...tk", w.conj(), X)


def blocking_matrix(v: torch.Tensor) -> torch.Tensor:
    """Householder complement of v per bin: (..., K, N) → (..., K, N, N-1)."""
    N = v.shape[-1]
    vn = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    v0 = vn[..., 0]
    a0 = v0.abs()
    one = torch.ones_like(v0)
    phi = torch.where(a0 > 1e-12, v0 / torch.clamp(a0, min=1e-30), one)
    u = vn.clone()
    u[..., 0] = u[..., 0] + phi
    uu = torch.sum(u.abs() ** 2, dim=-1)
    eye = torch.eye(N, dtype=v.dtype, device=v.device)
    H = eye - 2.0 * u[..., :, None] * u[..., None, :].conj() / uu[..., None, None]
    return H[..., :, 1:]


def ds_beamform(X: torch.Tensor, taus_sec, M: int, sample_rate: float) -> torch.Tensor:
    """Steering + delay-and-sum: X (N, T, K) complex, taus (N,) static or
    (T, N) per-frame trajectory (a tracker's) → (T, K).  Launches the fused
    steering kernel on a CUDA tensor."""
    taus = torch.as_tensor(taus_sec, dtype=torch.float32, device=X.device).contiguous()
    return _steer.ds_beamform(X.to(torch.complex64).contiguous(), taus, M, sample_rate)


def gsc_nlms(X: torch.Tensor, wq: torch.Tensor, B: torch.Tensor, mu: float = 0.1,
             eps: float = 1e-6, wa_norm_cap: float = 10.0,
             wa0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """GSC-NLMS, frame by frame.

    X (N, T, K) or batched (U, N, T, K); wq (..., K, N); B (..., K, N, N-1);
    wa0 (..., K, N-1) or None → (Y (..., T, K), wa (..., K, N-1)).  The
    final wa threads into the next chunk as `wa0` (streaming).  On CUDA
    tensors the whole recurrence is one launch of the GSC kernel.
    """
    single = X.dim() == 3          # one utterance of the batched form

    def c64(a):
        if a is None:
            return None
        return (a[None] if single else a).to(torch.complex64).contiguous()

    Y, wa = _gsc.gsc_nlms(c64(X), c64(wq), c64(B), float(mu), float(eps), float(wa_norm_cap),
                          c64(wa0))
    return (Y[0], wa[0]) if single else (Y, wa)


def _capped(wa: torch.Tensor, cap: float) -> torch.Tensor:
    nrm = torch.linalg.vector_norm(wa, dim=-1, keepdim=True)
    return wa * torch.clamp(cap / torch.clamp(nrm, min=1e-30), max=1.0)


def gsc_nlms_block(X: torch.Tensor, wq: torch.Tensor, B: torch.Tensor, mu: float = 0.1,
                   eps: float = 1e-6, wa_norm_cap: float = 10.0,
                   wa0: torch.Tensor | None = None,
                   block: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-adaptive GSC (block-LMS): one weight update per `block` frames,
    the gradient averaged over the block.  X (N, T, K) → (Y (T, K), wa
    (K, N-1)); tail frames past the last whole block use the final weights.
    """
    N, T, K = X.shape
    wa = (torch.zeros((K, N - 1), dtype=X.dtype, device=X.device) if wa0 is None
          else wa0.to(X.dtype))
    X_tkn = X.permute(1, 2, 0)                                       # (T, K, N)
    yc = torch.sum(wq.conj() * X_tkn, dim=-1)                        # (T, K)
    z = torch.einsum("knm,tkn->tkm", B.conj(), X_tkn)                # (T, K, N-1)
    nb = T // block
    Y = []
    for i in range(nb):
        zb = z[i * block:(i + 1) * block]
        y = yc[i * block:(i + 1) * block] - torch.einsum("km,bkm->bk", wa.conj(), zb)
        znorm = torch.sum(zb.abs() ** 2, dim=(0, 2)) / block        # (K,)
        grad = torch.einsum("bkm,bk->km", zb, y.conj()) / block
        wa = _capped(wa + mu * grad / (znorm[:, None] + eps), wa_norm_cap)
        Y.append(y)
    if nb * block < T:   # tail frames with frozen weights
        zt = z[nb * block:]
        Y.append(yc[nb * block:] - torch.einsum("km,bkm->bk", wa.conj(), zt))
    return torch.cat(Y, dim=0), wa


def gsc_rls(X: torch.Tensor, wq: torch.Tensor, B: torch.Tensor, forget: float = 0.99,
            delta: float = 1e2, wa_norm_cap: float = 10.0) -> tuple[torch.Tensor, torch.Tensor]:
    """GSC with RLS active weights, per bin k on the blocked references z:
        g = P z / (λ + zᴴ P z);  wa += g · conj(y);  P = (P - g zᴴ P)/λ
    X (N, T, K) → (Y (T, K), wa (K, N-1))."""
    K, N = wq.shape
    wa = torch.zeros((K, N - 1), dtype=X.dtype, device=X.device)
    P = (torch.eye(N - 1, dtype=X.dtype, device=X.device) * delta).repeat(K, 1, 1)
    X_tkn = X.permute(1, 2, 0)
    Y = []
    for x in X_tkn:
        yc = torch.sum(wq.conj() * x, dim=-1)
        z = torch.einsum("knm,kn->km", B.conj(), x)
        y = yc - torch.sum(wa.conj() * z, dim=-1)
        Pz = torch.einsum("kmn,kn->km", P, z)
        denom = forget + torch.sum(z.conj() * Pz, dim=-1).real
        g = Pz / denom[:, None].to(Pz.dtype)
        wa = _capped(wa + g * y.conj()[:, None], wa_norm_cap)
        P = (P - torch.einsum("km,kn->kmn", g, Pz.conj())) / forget
        Y.append(y)
    return torch.stack(Y), wa


def gsc_maxkurt(X: torch.Tensor, wq: torch.Tensor, B: torch.Tensor, mu: float = 0.1,
                iters: int = 50, wa_norm_cap: float = 2.0,
                decay: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """Maximum-kurtosis GSC, batch adaptation: `iters` steps of normalised,
    decaying-step kurtosis ascent, all K bins at once.
    X (N, T, K); wq (K, N); B (K, N, N-1) → (Y (T, K), wa (K, N-1))."""
    eps = 1e-12
    Z = torch.einsum("knm,ntk->kmt", B.conj(), X)                  # (K, N-1, T)
    yq = torch.einsum("kn,ntk->kt", wq.conj(), X)                  # (K, T)
    wa = torch.zeros((B.shape[0], B.shape[2]), dtype=X.dtype, device=X.device)
    for it in range(iters):
        y = yq - torch.einsum("km,kmt->kt", wa.conj(), Z)
        ay2 = y.abs() ** 2
        P = ay2.mean(dim=1)
        A = (ay2 ** 2).mean(dim=1)
        e_y2yz = ((ay2 * y.conj())[:, None, :] * Z).mean(dim=2)  # (K, N-1)
        e_yz = (y.conj()[:, None, :] * Z).mean(dim=2)
        g = (-2.0 * e_y2yz / torch.clamp(P * P, min=eps)[:, None]
             + (2.0 * A / torch.clamp(P ** 3, min=eps))[:, None] * e_yz)
        step = mu / (1.0 + it * decay)
        wa = wa + step * g / (torch.linalg.vector_norm(g, dim=1, keepdim=True) + eps)
        wa = _capped(wa, wa_norm_cap)
    Y = (yq - torch.einsum("km,kmt->kt", wa.conj(), Z)).T
    return Y, wa
