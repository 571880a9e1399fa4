"""Speaker-adaptive training (SAT) cascade (PyTorch).

Counterpart of `dsr_tpu/asr/adapt/sat.py`.  Standard fMLLR-SAT loop: per
speaker, estimate an fMLLR transform under the current model, transform
that speaker's features, re-accumulate ML stats on the transformed
features, re-estimate the model; iterate.  At test time the same
per-speaker estimation runs before decoding (the adaptation cascade).
Everything runs on the device of the parameters.
"""

from __future__ import annotations

import torch

from dsr_tpu_torch.asr.adapt import fmllr
from dsr_tpu_torch.asr.train import ml


def _on(params, a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=params.means.device)


def estimate_speaker_transform(params, feats_list, gamma_list, iters: int = 5) -> torch.Tensor:
    """Pool one speaker's utterances → fMLLR transform Wf (D, D+1)."""
    stats = [fmllr.accumulate_fmllr(params, _on(params, f), _on(params, g))
             for f, g in zip(feats_list, gamma_list)]
    pooled = fmllr.FmllrStats(*(sum(parts[1:], parts[0]) for parts in zip(*stats)))
    return fmllr.estimate_fmllr(pooled, iters=iters)


def sat_iteration_batched(params, feats, gammas, gamma_fn=None,
                          fmllr_iters: int = 5, var_floor: float = 1e-3):
    """One SAT round with the speakers on a batch axis (no loop over them).

    feats: (NS, U, T, D) — NS speakers × U utterances padded to one T
    (pad frames with gamma=0: every statistic is γ-weighted, so padding
    contributes nothing); gammas: (NS, U, T, S) state occupancies.
    gamma_fn: optional (params, feats (NS, U, T, D) tensor) → gammas
    tensor (NS, U, T, S), for re-alignment in the transformed feature
    space (e.g. batched GMM state posteriors); None reuses `gammas`.

    Returns (new_params, Ws (NS, D, D+1)).
    """
    feats, gammas = _on(params, feats), _on(params, gammas)
    NS, U, T, D = feats.shape
    stats = fmllr.speaker_stats(params, feats.reshape(NS, U * T, D),
                                gammas.reshape(NS, U * T, -1))      # pooled per speaker
    Ws = fmllr.estimate_fmllr(stats, iters=fmllr_iters)             # (NS, D, D+1)
    ft = fmllr.apply_fmllr(feats, Ws[:, None])                      # (NS, U, T, D)
    g2 = gammas if gamma_fn is None else _on(params, gamma_fn(params, ft))
    S, C, _ = params.means.shape
    acc = ml.accumulate(params, ft, g2, ml.zero_accum(S, C, D, feats.device))
    return ml.mstep(acc, var_floor=var_floor), Ws


def sat_iteration(params, speakers: dict, gamma_fn, num_comp: int, var_floor: float = 1e-3):
    """One SAT round.

    speakers: {spk: [feats (T, D), ...]};  gamma_fn(params, feats, spk_idx,
    utt_idx) → (T, S) occupancies (e.g. from forced alignment).
    Returns (new params, {spk: Wf}).
    """
    S, C, D = params.means.shape
    transforms = {}
    acc = ml.zero_accum(S, C, D, params.means.device)
    for spk, utts in speakers.items():
        gammas = [gamma_fn(params, f, spk, i) for i, f in enumerate(utts)]
        Wf = estimate_speaker_transform(params, utts, gammas)
        transforms[spk] = Wf
        for f in utts:
            ft = fmllr.apply_fmllr(_on(params, f), Wf)
            # re-align in the transformed space for sharper occupancies
            g2 = gamma_fn(params, ft.cpu().numpy(), spk, None)
            acc = ml.accumulate(params, ft, _on(params, g2), acc)
    new_params = ml.mstep(acc, var_floor=var_floor)
    return new_params, transforms
