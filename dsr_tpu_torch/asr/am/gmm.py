"""Diagonal-GMM acoustic model (PyTorch).

Counterpart of `dsr_tpu/asr/am/gmm.py`: the mixture log-likelihood is one
matmul,

    ll[t, (s,c)] = [x², x, 1]_t · W_(s,c)

with W rows packed from (-1/(2σ²), μ/σ², bias), then a logsumexp over the
component axis.  The product is a plain float32 `torch.matmul` (the JAX
package leaves it to XLA); the entry points keep TF32 off so the card
computes it in full float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from dsr_tpu_torch.utils import profiling


def _f32(a) -> torch.Tensor:
    """A float32 copy of an array or tensor (never a view of the caller's data)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).clone()
    return torch.tensor(np.asarray(a, np.float32))


class GmmParams(nn.Module):
    """Per-state diagonal GMMs: means and variances (S, C, D), log mixture
    weights (S, C), held as float32 buffers (moved by `.to(device)`)."""

    def __init__(self, means, variances, logweights):
        super().__init__()
        self.register_buffer("means", _f32(means))
        self.register_buffer("variances", _f32(variances))
        self.register_buffer("logweights", _f32(logweights))

    @property
    def num_states(self) -> int:
        return self.means.shape[0]

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return loglik(self, feats)


def pack_matmul_weights(p: GmmParams) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """→ (W (2D+1, S*C), (S, C, D)) for the single-matmul loglik."""
    S, C, D = p.means.shape
    inv_v = 1.0 / p.variances
    quad = -0.5 * inv_v                                   # (S, C, D)
    lin = p.means * inv_v
    bias = p.logweights - 0.5 * torch.sum(
        p.means**2 * inv_v + torch.log(2 * math.pi * p.variances), dim=-1
    )                                                     # (S, C)
    W = torch.cat(
        [
            quad.reshape(S * C, D).T,                     # x² rows
            lin.reshape(S * C, D).T,                      # x rows
            bias.reshape(1, S * C),                       # 1 row
        ],
        dim=0,
    )
    return W, (S, C, D)


def _component_loglik(p: GmmParams, feats: torch.Tensor) -> torch.Tensor:
    W, (S, C, _) = pack_matmul_weights(p)
    ones = torch.ones((*feats.shape[:-1], 1), dtype=feats.dtype, device=feats.device)
    xext = torch.cat([feats**2, feats, ones], dim=-1)      # (…, T, 2D+1)
    return (xext @ W).reshape(*feats.shape[:-1], S, C)


def loglik(p: GmmParams, feats: torch.Tensor) -> torch.Tensor:
    """(…, T, D) → (…, T, S) mixture log-likelihoods (one matmul)."""
    with profiling.scope("gmm.loglik"):
        return torch.logsumexp(_component_loglik(p, feats), dim=-1)


def component_posteriors(p: GmmParams, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (state loglik (…, T, S), per-component posterior (…, T, S, C))."""
    ll = _component_loglik(p, feats)
    state_ll = torch.logsumexp(ll, dim=-1)
    return state_ll, torch.exp(ll - state_ll[..., None])
