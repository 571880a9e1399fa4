"""Single-device forward of the flagship front end (PyTorch).

Counterpart of `__graft_entry__._pipeline_fn`: an 8-channel circular array
(radius 0.10 m), filterbank M=256 m=4 r=2, superdirective MVDR towards
(0, 2, 0) m, subband MFCC + CMN, and diagonal-GMM log-likelihoods for 16
states of 2 components.  The GMM parameters and the input come from the
same seeded numpy generator, drawn in the same order, so both packages
compute with identical numbers.

    fwd, (x,) = entry()          # on the card; entry("cpu") for the CPU
    ll = fwd(x)                  # (T, 16) log-likelihoods
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.config import ArrayGeometry, FilterbankConfig
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.utils.design import get_prototypes, steering_delays
from dsr_tpu_torch.utils.device import resolve


@dataclass
class Forward:
    """x_multi (N, S) waveforms → (T, S_states) acoustic log-likelihoods."""

    cfg: FilterbankConfig
    hf: torch.Tensor               # (L,) float32 analysis prototype
    w: torch.Tensor                # (K, N) complex64 MVDR weights
    params: gmm.GmmParams
    sample_rate: float

    def __call__(self, x_multi: torch.Tensor) -> torch.Tensor:
        A = fb.analysis(x_multi, self.cfg, self.hf)
        Y = bf.apply_weights(A, self.w)
        feats = ft.cmn(ft.mfcc_from_subbands(Y, self.cfg.M, self.sample_rate))
        return gmm.loglik(self.params, feats)


def _pipeline_fn(device=None) -> tuple[Forward, tuple[torch.Tensor]]:
    dev = resolve(device)
    SR = 16000.0
    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    taus = (steering_delays(POS, np.array([0.0, 2.0, 0.0]), 343.0, SR) / SR).astype(np.float32)
    hf, _, _ = get_prototypes(cfg)
    rng = np.random.default_rng(0)
    S_states, C, D = 16, 2, 13
    params = gmm.GmmParams(
        rng.standard_normal((S_states, C, D)),
        0.5 + rng.random((S_states, C, D)),
        np.log(np.full((S_states, C), 1.0 / C)),
    ).to(dev)
    Gamma = bf.diffuse_coherence(POS, cfg.M, SR, 343.0, dev)
    v = bf.steering_vectors(torch.as_tensor(taus, device=dev), cfg.M, SR)
    w = bf.mvdr_weights(v, Gamma, 1e-2)
    hf_t = torch.as_tensor(np.asarray(hf, np.float32), device=dev)
    x = rng.standard_normal((8, 16000)).astype(np.float32)
    return Forward(cfg, hf_t, w, params, SR), (torch.as_tensor(x, device=dev),)


def entry(device=None) -> tuple[Forward, tuple[torch.Tensor]]:
    """(forward, (x,)): the forward and its seeded 8 × 16000 input."""
    return _pipeline_fn(device)
