"""Port parity: the batched ML trainer (`dsr_tpu_torch/asr/train/
{trainer,ml}.py`) against the JAX package's, on 8 utterances of the
synthetic corpus in 2 iterations (the JAX gate trains 60 x 4), with the
same features (the port's MFCC + CMN as numpy) fed to both.

Tolerances, relative as |a - b| / (|b| + 1) over every entry:
  - Viterbi E-step: 5e-4.  The flat start is the same numpy draw, the
    alignments are equal, and the accumulators differ only in float32
    summation order (measured ~4e-5).
  - Baum-Welch E-step: 5e-3.  Soft posteriors from float32 log-domain
    forward-backward over ~130 frames differ at ~1e-3 between the two
    libraries (the JAX package's own BW gate allows 2e-2 against float64).
Decoded words must be equal.
"""

import numpy as np
import torch

from _torch_parity import config1_corpus, smallvocab_pair
from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.asr.train import trainer as jtrainer
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.train import trainer


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref) / (np.abs(ref) + 1.0)))


def _train_both(estep):
    jtask, task = smallvocab_pair()
    feats, words = config1_corpus(8)
    p_j = jtrainer.train(jtask, feats, words, num_comp=2, iters=2, estep=estep)
    p = trainer.train(task, feats, words, num_comp=2, iters=2, estep=estep, device="cpu")
    return (jtask, p_j), (task, p), feats


def test_train_viterbi_and_decode_match_jax():
    (jtask, p_j), (task, p), feats = _train_both("viterbi")
    for name in ("means", "variances", "logweights"):
        assert _rel(getattr(p, name).numpy(), getattr(p_j, name)) < 5e-4, name
    assert trainer.decode(task, p, feats) == jtrainer.decode(jtask, p_j, feats)


def test_train_baum_welch_matches_jax():
    (_, p_j), (_, p), _ = _train_both("bw")
    for name in ("means", "variances", "logweights"):
        assert _rel(getattr(p, name).numpy(), getattr(p_j, name)) < 5e-3, name


def test_baum_welch_estep_accumulators_match_jax():
    """trainer._estep_bw on the flat start against the JAX package's, on
    three-word vocabulary utterances as tests/test_asr_smallvocab.py's BW
    gate builds them."""
    jtask, task = smallvocab_pair(["ash", "echo", "east"])
    feats, words = config1_corpus(6, seed=7, vocab=task.vocab)
    init = trainer.init_gmm_from_feats(feats, [task.align_graph(w)[0] for w in words],
                                       task.num_states, 2, np.random.default_rng(7))
    p = gmm.GmmParams(*init)
    p_j = jgmm.GmmParams(*(np.asarray(a, np.float32) for a in init))
    padded, lengths = trainer.pad_corpus(feats)
    graphs = trainer.pad_align_graphs(task, words)
    acc_j, total_j = jtrainer._estep_bw(p_j, padded, lengths, *graphs, task.num_states)
    acc, total = trainer._estep_bw(p, *trainer.estep_inputs(task, feats, words, "cpu"),
                                   task.num_states)
    assert abs(float(total) - float(total_j)) <= 1e-4 * abs(float(total_j))
    for a, a_j in zip(acc, acc_j):
        assert _rel(a.numpy(), a_j) < 5e-3
    assert torch.all(acc.occ >= 0)
