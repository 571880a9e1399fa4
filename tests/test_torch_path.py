"""Port parity: forced alignment (`dsr_tpu_torch/asr/path.py`) against the
JAX package's `force_align` on CPU tensors (both run the dense `viterbi`
there), for the whole-word `SmallVocabTask` and the phone-level
`PhoneTask`, with a seeded GMM on features of the synthetic corpus.  On
the card the port sends these chains to the banded kernel; the banded
twin is held here to the dense alignment on the same graphs.

Tolerance: states and segments equal; the score within 1e-3 relative
(float32 GMM log-likelihoods summed over ~130 frames, by two libraries).
Banded against dense: states equal and the score within 1e-5 relative,
on scores without exact ties (the two break a tie differently: self
against advance).
"""

import numpy as np
import torch

from _torch_parity import config1_corpus, gmm_pair, phone_pair, smallvocab_pair
from dsr_tpu.asr import path as jpath
from dsr_tpu_torch.asr import path
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.ops.cuda import viterbi as cvit


def _check_task(pair, seed):
    jtask, task = pair
    feats, words = config1_corpus(3, seed=seed)
    jp, p = gmm_pair(np.random.default_rng(seed), task.num_states)
    for f, ws in zip(feats, words):
        a_j = jpath.force_align(jtask, jp, f, ws)
        a = path.force_align(task, p, f, ws)
        assert np.array_equal(a.states, np.asarray(a_j.states))
        assert a.segments == a_j.segments
        assert abs(a.score - a_j.score) <= 1e-3 * abs(a_j.score)
        assert a.segments[0][1] == 0 and a.segments[-1][2] == len(f)


def test_force_align_smallvocab_matches_jax():
    _check_task(smallvocab_pair(), 11)


def test_force_align_phone_task_matches_jax():
    _check_task(phone_pair(), 12)


def test_banded_alignment_equals_dense_on_continuous_scores():
    """What the card runs (the banded recursion on the chain's diagonals,
    adv_lp[0] = -1e30, init[0] + final[L-1] added) against the CPU's dense
    alignment on the same graphs.  The GMM scores are continuous, so no
    exact tie between staying and advancing occurs and the positions are
    equal frame by frame (chip_smoke.py counts ties on the card)."""
    _, task = smallvocab_pair()
    feats, words = config1_corpus(4, seed=13)
    _, p = gmm_pair(np.random.default_rng(13), task.num_states)
    for f, ws in zip(feats, words):
        ids, A, init, final = task.align_graph(ws)
        assert path._is_linear_chain(A, init, final)
        ll = gmm.loglik(p, torch.as_tensor(f))[:, torch.as_tensor(ids, dtype=torch.int64)]
        self_lp = torch.as_tensor(np.diag(A).astype(np.float32))
        adv_lp = torch.as_tensor(np.r_[-1e30, np.diag(A, 1)].astype(np.float32))
        bp, delta = cvit.banded_viterbi(ll[None].contiguous(), self_lp, adv_lp)
        banded = cvit.best_path(bp)[0]
        dense = path.force_align(task, p, f, ws)
        assert np.array_equal(np.asarray(ids)[banded], dense.states)
        score = float(delta[0, -1]) + float(init[0]) + float(final[-1])
        assert abs(score - dense.score) <= 1e-5 * abs(dense.score)
