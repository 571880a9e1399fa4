"""Per-speaker VTLN warp-factor estimation (PyTorch).

Counterpart of `dsr_tpu/asr/adapt/vtln.py`: an ML grid search over warp
factors against forced alignments.  Per speaker: recompute MFCCs at each
candidate warp (the mel filterbank edges move by the piecewise-linear
map of `utils.design.vtln_warp_freq`), forced-align the speaker's
utterances under the current AM, and pick the warp maximising the total
alignment log-likelihood.  A speaker whose formants sit at s× the
training speakers' is recovered at warp ≈ 1/s.

Each warp's features are `features.mfcc` on the device of the parameters,
and each alignment is `path.force_align` there (on the card, one launch
of the banded Viterbi kernel per utterance).
"""

from __future__ import annotations

import numpy as np
import torch

from dsr_tpu_torch.asr import path as apath
from dsr_tpu_torch.ops import features as ft

DEFAULT_WARPS = tuple(np.round(np.arange(0.85, 1.1501, 0.025), 4))


def estimate_warp(task, params, utts, transcripts,
                  sample_rate: float = 16000.0, warps=None, feats_fn=None):
    """ML grid search for one speaker's warp factor.

    utts: list of waveforms; transcripts: list of word sequences;
    feats_fn(x, warp) → (T, D) features (default: cmn(mfcc(x, sr,
    vtln_warp=warp)) on the device of `params`).  Returns (best_warp,
    {warp: total loglik}).
    """
    if feats_fn is None:
        dev = params.means.device

        def feats_fn(x, w):
            x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            return ft.cmn(ft.mfcc(x, sample_rate, vtln_warp=float(w))).cpu().numpy()

    warps = DEFAULT_WARPS if warps is None else warps
    scores: dict = {}
    for a in warps:
        tot = 0.0
        for x, ws in zip(utts, transcripts):
            al = apath.force_align(task, params, feats_fn(x, a), ws)
            tot += al.score
        scores[float(a)] = tot
    best = max(scores, key=scores.get)
    return best, scores
