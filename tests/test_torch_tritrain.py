"""Port parity: tied-triphone training (`dsr_tpu_torch/asr/tritrain.py`)
against the JAX package's `train_tied_triphone`, on 8 utterances of the
synthetic corpus (the port's MFCC + CMN as numpy, fed to both) from the
same monophone parameters (trained by the JAX package in 2 iterations and
carried across by `convert.gmm_params`), with 2 tied iterations.

Tolerance: the tree must be the same node for node (the monophone
alignments are equal, so the float64 context statistics are too); the
tied parameters within 5e-4 relative as |a - b| / (|b| + 1), the trainer
tests' Viterbi tolerance (float32 sums in another order over equal
alignments; measured ~5e-5).  The tied alignment chains must be equal.
"""

import numpy as np
import pytest

from _torch_parity import config1_corpus, phone_pair
from dsr_tpu.asr import tritrain as jtritrain
from dsr_tpu.asr.train import trainer as jtrainer
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr import tritrain


@pytest.fixture(scope="module")
def systems():
    jtask, task = phone_pair()
    feats, words = config1_corpus(8)
    mono_j = jtrainer.train(jtask, feats, words, num_comp=2, iters=2)
    tri_j = jtritrain.train_tied_triphone(jtask, mono_j, feats, words, iters=2)
    tri = tritrain.train_tied_triphone(task, convert.gmm_params(mono_j), feats, words, iters=2,
                                       device="cpu")
    return tri, tri_j, words


def test_tied_triphone_tree_and_parameters_match_jax(systems):
    tri, tri_j, _ = systems
    assert tri.stats_contexts == tri_j.stats_contexts > tri.tree.num_leaves > 5
    assert tri.tree == convert.distrib_tree(tri_j.tree)
    for name in ("means", "variances", "logweights"):
        a, b = getattr(tri.params, name).numpy(), np.asarray(getattr(tri_j.params, name))
        assert a.shape == b.shape
        assert float(np.max(np.abs(a - b) / (np.abs(b) + 1.0))) < 5e-4, name


def test_tied_alignment_chains_match_jax(systems):
    tri, tri_j, words = systems
    assert tri.task.num_states == tri_j.task.num_states
    for ws in words:
        assert tri.task.phone_seq(ws) == tri_j.task.phone_seq(ws)
        for a, b in zip(tri.task.align_graph(ws), tri_j.task.align_graph(ws)):
            assert np.array_equal(a, np.asarray(b))
