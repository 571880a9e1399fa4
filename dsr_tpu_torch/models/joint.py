"""Joint neural-beamformer + Conformer-CTC training (PyTorch) — BASELINE
config 5's learned front end trained end to end.

Counterpart of `dsr_tpu/models/joint.py`: multichannel subbands →
mask-MVDR (`neural_beamformer.py`; the CTC gradient reaches the mask
estimator through the solve) → subband MFCC + CMN (`ops/features.py`) →
`ConformerCtc` → CTC loss.  `make_train_step` updates both parameter
subtrees in one step; `OracleMvdrCtc` is the frozen oracle-MVDR baseline.
"""

from __future__ import annotations

import torch
from torch import nn

from dsr_tpu_torch.models.conformer import ConformerCtc, _generator, ctc_loss
from dsr_tpu_torch.models.neural_beamformer import NeuralBeamformer
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.utils.device import resolve


class JointBeamformerCtc(nn.Module):
    """(B, N, T, K) complex subband snapshots → CTC logits (B, ceil(T/4),
    vocab+1).  Parameters split into `frontend` (the mask estimator) and
    `am` (the Conformer); both receive the CTC loss's gradient."""

    def __init__(self, vocab: int, subbands_m: int, sample_rate: float = 16000.0,
                 dim: int = 64, layers: int = 2, heads: int = 2, hidden: int = 64, *,
                 device=None, generator=None):
        super().__init__()
        device, g = resolve(device), _generator(generator)
        self.subbands_m, self.sample_rate = subbands_m, sample_rate
        self.frontend = NeuralBeamformer(subbands_m // 2 + 1, hidden, device=device, generator=g)
        self.am = ConformerCtc(vocab, dim, layers, heads, device=device, generator=g)

    def forward(self, X):
        enh = self.frontend(X)                                         # (B, T, K)
        return self.am(ft.cmn(ft.mfcc_from_subbands(enh, self.subbands_m, self.sample_rate)))


class OracleMvdrCtc(nn.Module):
    """The config-5 baseline front end: fixed oracle-steered MVDR weights w
    (K, N), computed outside from the true source position, then the same
    features and `ConformerCtc`."""

    def __init__(self, vocab: int, subbands_m: int, sample_rate: float = 16000.0,
                 dim: int = 64, layers: int = 2, heads: int = 2, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve(device)
        self.subbands_m, self.sample_rate = subbands_m, sample_rate
        self.am = ConformerCtc(vocab, dim, layers, heads, device=device, generator=generator)

    def forward(self, X, w):
        enh = torch.einsum("kn,bntk->btk", w.conj(), X)
        return self.am(ft.cmn(ft.mfcc_from_subbands(enh, self.subbands_m, self.sample_rate)))


def apply_gradients(model: JointBeamformerCtc, optimizer: torch.optim.Optimizer,
                    frozen_frontend: bool = False, clip_norm: float | None = None) -> None:
    """The train step's update from the gradients in each parameter's
    `.grad`: the frontend's zeroed when it is frozen (its parameters stay
    in the optimiser, so Adam's moments stay zero as optax's do), then
    `optax.clip_by_global_norm(clip_norm)` (g / ‖g‖ · clip where ‖g‖ ≥
    clip, over every gradient), then the optimiser's step."""
    if frozen_frontend:
        for p in model.frontend.parameters():
            p.grad = torch.zeros_like(p)
    if clip_norm is not None:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < clip_norm, g, g / norm * clip_norm))
    optimizer.step()


def make_train_step(model: JointBeamformerCtc, optimizer: torch.optim.Optimizer,
                    frozen_frontend: bool = False, clip_norm: float | None = None):
    """step(X, labels, label_lens, frame_lens=None) → the batch's loss
    (a 0-d tensor, before the update); updates `model` in place.

    frame_lens (B,) gives each utterance's valid subband-frame count in
    X's T axis; the CTC loss then masks the padded logit frames (valid
    logits min((frame_lens + 3) // 4, T')).  Omitted, every frame counts.
    frozen_frontend trains the AM alone with the same step (the ablation
    baselines); clip_norm clips the global gradient norm first."""

    def step(X, labels, label_lens, frame_lens=None):
        optimizer.zero_grad()
        logits = model(X)
        B, T = logits.shape[:2]
        if frame_lens is None:
            llen = torch.full((B,), T, dtype=torch.long)
        else:
            llen = torch.clamp_max((torch.as_tensor(frame_lens) + 3) // 4, T)
        loss = ctc_loss(logits, llen, labels, label_lens)
        loss.backward()
        apply_gradients(model, optimizer, frozen_frontend, clip_norm)
        return loss.detach()

    return step
