"""Port parity: the time-domain MFCC (`dsr_tpu_torch.ops.features.mfcc`)
and CMN against the JAX package's, on 1 s of seeded audio and on a
synthetic-corpus utterance (the features of BASELINE config 1).

Tolerance: 1e-4 of the largest magnitude.  Both compute a float32 rfft,
mel projection and DCT; the FFTs (pocketfft against XLA's) round
differently, and the log of small mel energies amplifies that (measured
~4e-6).
"""

import numpy as np
import torch

from _torch_parity import SR, rel
from dsr_tpu.ops import features as jft
from dsr_tpu_torch.ops import features as ft
from dsr_tpu_torch.utils import corpus


def test_mfcc_and_cmn_match_jax_on_seeded_audio():
    x = (np.random.default_rng(0).standard_normal(int(SR)) * 0.3).astype(np.float32)
    f_j = np.asarray(jft.mfcc(x, SR))
    f = ft.mfcc(torch.as_tensor(x), SR)
    assert f.shape == f_j.shape == (98, 13)
    assert rel(f.numpy(), f_j) < 1e-4
    assert rel(ft.cmn(f).numpy(), np.asarray(jft.cmn(f_j))) < 1e-4


def test_mfcc_batched_channels_and_corpus_utterance_match_jax():
    _, x = corpus.make_corpus(1, seed=5)[0]
    xs = np.stack([x, 0.5 * x[::-1]]).astype(np.float32)
    f_j = np.asarray(jft.cmn(jft.mfcc(xs, SR, num_mel=24, preemph=0.95)))
    f = ft.cmn(ft.mfcc(torch.as_tensor(xs), SR, num_mel=24, preemph=0.95))
    assert f.shape == f_j.shape and f.shape[0] == 2
    assert rel(f.numpy(), f_j) < 1e-4
