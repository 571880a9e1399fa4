"""Compose-stages public API of the PyTorch front end.

Counterpart of `dsr_tpu.pipeline.DsrPipeline` for the fixed beamformers:
multichannel waveform → subband analysis → DS or superdirective MVDR
beamform → synthesis, plus subband MFCC (+ CMN).  It runs on the card
unless `device` names another (`device="cpu"` runs the plain path).

    pipe = DsrPipeline(fb=FilterbankConfig(M=256, m=4, r=2),
                       geometry=ArrayGeometry.circular(8, 0.10),
                       beamformer=BeamformerConfig(kind="mvdr"))
    y, feats = pipe.process(x_multi, source_pos=np.array([0., 2., 0.]))

Not ported yet (ROADMAP): the GSC beamformer, the post-filters, WPE
dereverberation, and the streaming API with its recogniser.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dsr_tpu_torch.config import ArrayGeometry, BeamformerConfig, FilterbankConfig, FrontendConfig
from dsr_tpu_torch.ops import beamforming as bf
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.ops import filterbank as fb
from dsr_tpu_torch.utils import design
from dsr_tpu_torch.utils.device import resolve


@dataclass
class DsrPipeline:
    fb: FilterbankConfig = field(default_factory=FilterbankConfig)
    geometry: ArrayGeometry = field(default_factory=lambda: ArrayGeometry.linear(8, 0.04))
    beamformer: BeamformerConfig = field(default_factory=BeamformerConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    postfilter: str | None = None
    dereverb: bool = False
    device: str | torch.device | None = None
    # Γl⁻¹ of the MVDR beamformer: geometry only, so computed once here
    # (as bench.py hoists it); each request then costs a batched matvec.
    _gamma_inv: torch.Tensor | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.beamformer.kind == "gsc":
            raise NotImplementedError(
                "kind='gsc' is not ported yet: it comes with the GSC kernel "
                "(ROADMAP, Queue 2: ops/pallas/gsc.py _gsc_kernel)")
        if self.beamformer.kind not in ("ds", "mvdr"):
            raise ValueError(f"unknown beamformer kind {self.beamformer.kind!r}")
        if self.postfilter is not None:
            raise NotImplementedError(
                f"postfilter={self.postfilter!r} is not ported yet "
                "(ROADMAP, Queue 1: the rest of ops/, postfilter)")
        if self.dereverb:
            raise NotImplementedError(
                "dereverb=True is not ported yet (ROADMAP, Queue 1: the rest of ops/, dereverb)")
        self.device = resolve(self.device)
        if self.beamformer.kind == "mvdr":
            Gamma = bf.diffuse_coherence(np.asarray(self.geometry.positions), self.fb.M,
                                         float(self.frontend.sample_rate),
                                         self.geometry.sound_speed, self.device)
            self._gamma_inv = bf.mvdr_precompute(Gamma, self.beamformer.diagonal_loading)

    def steering_delays(self, source_pos: np.ndarray) -> np.ndarray:
        POS = np.asarray(self.geometry.positions)
        return (
            design.steering_delays(POS, np.asarray(source_pos), self.geometry.sound_speed,
                                   self.frontend.sample_rate)
            / self.frontend.sample_rate
        ).astype(np.float32)

    def weights(self, source_pos: np.ndarray) -> torch.Tensor:
        """Fixed beamformer weights (K, N) complex64 for a source position."""
        sr = float(self.frontend.sample_rate)
        taus = torch.as_tensor(self.steering_delays(source_pos), device=self.device)
        v = bf.steering_vectors(taus, self.fb.M, sr)
        if self.beamformer.kind == "ds":
            return bf.ds_weights(v)
        return bf.mvdr_weights_from_inv(v, self._gamma_inv)

    def beamform_subbands(self, A: torch.Tensor, source_pos: np.ndarray):
        """A: (N, T, K) analysis output → (Y (T, K), None); the second item
        stands for the adaptive beamformers' state, which DS and MVDR lack."""
        return bf.apply_weights(A, self.weights(source_pos)), None

    def process(self, x_multi, source_pos: np.ndarray):
        """(N, S) waveforms → (enhanced waveform (S,), features (T', D))."""
        x = torch.as_tensor(x_multi, dtype=torch.float32, device=self.device)
        A = fb.analysis(x, self.fb)
        Y, _ = self.beamform_subbands(A, source_pos)
        y = fb.synthesis(Y, self.fb, x.shape[-1])
        feats = ft.mfcc_from_subbands(
            Y, self.fb.M, self.frontend.sample_rate,
            num_mel=self.frontend.num_mel, num_cepstra=self.frontend.num_cepstra,
            fmin=self.frontend.fmin, fmax=self.frontend.fmax,
            vtln_warp=self.frontend.vtln_warp,
        )
        if self.frontend.cmn:
            feats = ft.cmn(feats)
        return y, feats
