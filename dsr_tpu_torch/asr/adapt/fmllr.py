"""fMLLR / CMLLR feature-space adaptation (PyTorch).

Counterpart of `dsr_tpu/asr/adapt/fmllr.py`.  Estimates an affine feature
transform  x' = A x + b  maximising the EM auxiliary
Q = β·log|A| − ½ Σ_d w_dᵀ G_d w_d − 2 w_dᵀ k_d  (diagonal covariance),
with the standard iterative row update using cofactors:
    w_d ← G_d⁻¹ (k_d + α c_d),  α from the quadratic in the cofactor row.

Statistics (their own accumulation pass — they weight by 1/σ² per dim):
    G_d = Σ_g (1/σ²_{g,d}) Σ_t γ_{t,g} [x_t;1][x_t;1]ᵀ     (D, D+1, D+1)
    k_d = Σ_g (μ_{g,d}/σ²_{g,d}) Σ_t γ_{t,g} [x_t;1]       (D, D+1)
    β   = total occupancy

Everything is float32 on the device of the parameters, as the reference
computes it; the row update runs batched over any leading (speaker) axes
of the statistics, so SAT estimates every speaker's transform at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dsr_tpu_torch.asr.am.gmm import GmmParams, component_posteriors


class FmllrStats(NamedTuple):
    G: torch.Tensor     # (..., D, D+1, D+1)
    k: torch.Tensor     # (..., D, D+1)
    beta: torch.Tensor  # (...)


def speaker_stats(params: GmmParams, feats: torch.Tensor, gamma: torch.Tensor) -> FmllrStats:
    """Per-speaker statistics: feats (N, T, D), gamma (N, T, S) → FmllrStats
    with a leading axis N (each speaker's frames summed)."""
    _, post = component_posteriors(params, feats)        # (N, T, S, C)
    w = post * gamma[..., None]
    ones = torch.ones((*feats.shape[:-1], 1), dtype=feats.dtype, device=feats.device)
    xe = torch.cat([feats, ones], dim=-1)                # (N, T, D+1)
    inv_v = 1.0 / params.variances                       # (S, C, D)
    occ_t = torch.einsum("ntsc,scd->ntd", w, inv_v)      # per-frame, per-dim weight
    G = torch.einsum("ntd,nti,ntj->ndij", occ_t, xe, xe)
    k_t = torch.einsum("ntsc,scd->ntd", w, params.means * inv_v)
    k = torch.einsum("ntd,nti->ndi", k_t, xe)
    return FmllrStats(G, k, w.sum(dim=(1, 2, 3)))


def accumulate_fmllr(params: GmmParams, feats: torch.Tensor, gamma: torch.Tensor) -> FmllrStats:
    """feats: (..., T, D); gamma: (..., T, S) → FmllrStats (summed)."""
    s = speaker_stats(params, feats.reshape(1, -1, feats.shape[-1]),
                      gamma.reshape(1, -1, gamma.shape[-1]))
    return FmllrStats(s.G[0], s.k[0], s.beta[0])


def estimate_fmllr(stats: FmllrStats, iters: int = 10, reg: float = 1e-4) -> torch.Tensor:
    """→ Wf (..., D, D+1) with x' = Wf [x; 1]; initialised at identity."""
    G, k, beta = stats
    D = k.shape[-2]
    dev, dt = k.device, k.dtype
    G = G + reg * torch.eye(D + 1, dtype=dt, device=dev)
    W = torch.cat([torch.eye(D, dtype=dt, device=dev), torch.zeros((D, 1), dtype=dt, device=dev)],
                  dim=1).expand(*k.shape[:-2], D, D + 1).clone()
    zero = torch.zeros((*k.shape[:-2], 1), dtype=dt, device=dev)
    for _ in range(iters):
        for d in range(D):
            A = W[..., :D]
            # cofactor row d of A: det(A) · (A⁻ᵀ)_d  (direction only matters)
            cof = torch.linalg.det(A)[..., None] * torch.linalg.inv(A)[..., :, d]
            c = torch.cat([cof, zero], dim=-1)
            Gd, kd = G[..., d, :, :], k[..., d, :]
            Ginv_k = torch.linalg.solve(Gd, kd)
            Ginv_c = torch.linalg.solve(Gd, c)
            a2 = (c * Ginv_c).sum(-1)
            a1 = (c * Ginv_k).sum(-1)
            # β = α (a1 + α a2) → the quadratic a2 α² + a1 α − β = 0
            disc = torch.sqrt(torch.clamp_min(a1 * a1 + 4 * a2 * beta, 0.0))
            alpha1 = (-a1 + disc) / (2 * a2)
            alpha2 = (-a1 - disc) / (2 * a2)

            def q_of(alpha):
                wd = Ginv_k + alpha[..., None] * Ginv_c
                quad = torch.einsum("...i,...ij,...j->...", wd, Gd, wd)
                return (beta * torch.log(torch.abs((wd * c).sum(-1)) + 1e-30) - 0.5 * quad
                        + (wd * kd).sum(-1))

            alpha = torch.where(q_of(alpha1) >= q_of(alpha2), alpha1, alpha2)
            W[..., d, :] = Ginv_k + alpha[..., None] * Ginv_c
    return W


def apply_fmllr(feats: torch.Tensor, Wf: torch.Tensor) -> torch.Tensor:
    """x' = A x + b over (..., T, D); Wf (D, D+1), or with leading axes
    that broadcast against feats' leading axes."""
    D = feats.shape[-1]
    return feats @ Wf[..., :D].transpose(-1, -2) + Wf[..., None, :, D]
