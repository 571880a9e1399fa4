"""Port parity: the port's copies of the synthetic corpus
(`dsr_tpu_torch/utils/corpus.py`), of the config-1 tasks' graphs
(`asr/smallvocab.py`, `asr/phone_task.py`) and of the WER metrics
(`utils/metrics.py`) against `golden.corpus` and the JAX package.

Tolerance: none.  The corpus makes the same rng draws in the same order,
so its arrays must be equal bit for bit; the graphs are built in numpy by
the same code; edit distances are integers.
"""

import numpy as np

from _torch_parity import phone_pair, smallvocab_pair
from dsr_tpu.utils import metrics as jmetrics
from dsr_tpu_torch.utils import corpus, metrics
from golden import corpus as gcorpus


def test_corpus_copy_equals_golden_bitwise():
    assert corpus.PHONES == gcorpus.PHONES and corpus.WORDS == gcorpus.WORDS
    assert corpus.VOCAB == gcorpus.VOCAB
    for seed, n, lo, hi in ((0, 4, 2, 5), (123, 3, 1, 2)):
        ours = corpus.make_corpus(n, min_words=lo, max_words=hi, seed=seed)
        ref = gcorpus.make_corpus(n, min_words=lo, max_words=hi, seed=seed)
        for (w, x), (w_ref, x_ref) in zip(ours, ref):
            assert w == w_ref and x.dtype == x_ref.dtype and np.array_equal(x, x_ref)


def test_task_graphs_equal_the_jax_package():
    words = ["moon", "ash", "tree"]
    for jt, t in (smallvocab_pair(), phone_pair()):
        for a, b in zip(jt.align_graph(words), t.align_graph(words)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert jt.num_states == t.num_states
    jsv, sv = smallvocab_pair()
    for a, b in zip(jsv.decode_graph(), sv.decode_graph()):
        assert np.array_equal(a, b)
    path = np.array([0, 0, 7, 7, 8, 0, 1, 1, 2, 0, 7, 8])
    assert jsv.path_to_words(path) == sv.path_to_words(path)
    jpt, pt = phone_pair()
    assert [pt.phones.name(i) for i in range(len(pt.phones))] == [
        jpt.phones.name(i) for i in range(len(jpt.phones))]


def test_edit_distance_and_wer_equal_the_jax_package():
    rng = np.random.default_rng(3)
    sc, jsc = metrics.WerScorer(), jmetrics.WerScorer()
    for _ in range(40):
        ref = [corpus.VOCAB[i] for i in rng.integers(0, 10, rng.integers(0, 7))]
        hyp = [corpus.VOCAB[i] for i in rng.integers(0, 10, rng.integers(0, 7))]
        assert metrics.edit_distance(ref, hyp) == jmetrics.edit_distance(ref, hyp)
        sc.add(ref, hyp)
        jsc.add(ref, hyp)
    assert (sc.subs, sc.dels, sc.ins, sc.num_ref) == (jsc.subs, jsc.dels, jsc.ins, jsc.num_ref)
    assert sc.wer == jsc.wer and str(sc) == str(jsc)
