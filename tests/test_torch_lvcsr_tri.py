"""Port parity: the triphone LVCSR task (`dsr_tpu_torch/asr/lvcsr.py`'s
`build_task_tri`, `synthetic_am_tri`, `synthesize_utterance_tri`) against
the JAX package's at V = 50 (34,977 states, 110,430 arcs, 873 tied pdfs),
and the in-domain decode of tests/test_lvcsr.py's triphone gate on it:
the port's dense and degree-split decoders (the split one with an `eg`
sized from the graph, no overflowed frame) against the JAX package's
sort path (`select_mode="xla"`).

Tolerance: none.  The graph, the tree and the analytic means come from the
same float64 / float32 arithmetic in the same order, so every array must
be equal bit for bit, and the decoded words equal (and equal to the
sentence).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsr_tpu.asr import lvcsr as jlvcsr
from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr import lvcsr
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import split_decoder as sd
from dsr_tpu_torch.asr.decoder import topk_decoder as tk

V50 = dict(vocab_size=50, n_tokens=1000, branching=3)


@pytest.fixture(scope="module")
def tasks():
    return lvcsr.build_task_tri(lvcsr.LvcsrConfig(**V50)), jlvcsr.build_task_tri(
        jlvcsr.LvcsrConfig(**V50))


def test_build_task_tri_matches_jax(tasks):
    task, jtask = tasks
    g, jg = task.graph, jtask.graph
    assert (g.start, g.num_states, g.num_arcs) == (jg.start, jg.num_states, 110430)
    for name in ("src", "pdf", "olabel", "dst", "weight", "final_weight"):
        a, b = np.asarray(getattr(g, name)), np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    timing = ("build_fsts_s", "build_tri_s")
    assert ({k: v for k, v in task.build_stats.items() if k not in timing}
            == {k: v for k, v in jtask.build_stats.items() if k not in timing})
    assert task.num_pdfs == jtask.num_pdfs == 873
    assert task.am_means.tobytes() == jtask.am_means.tobytes()
    assert task.tree == convert.distrib_tree(jtask.tree)
    assert task.words.id2name == jtask.words.id2name and task.lexicon == jtask.lexicon
    am, jam = lvcsr.synthetic_am_tri(task, device="cpu"), jlvcsr.synthetic_am_tri(jtask)
    for a, b in zip((am.means, am.variances, am.logweights), jam):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_in_domain_decode_matches_jax(tasks):
    task, jtask = tasks
    rng0 = np.random.default_rng(0)
    lex = lvcsr.make_lexicon(V50["vocab_size"], rng0)
    text = lvcsr.make_text(sorted(lex), V50["n_tokens"], V50["branching"], rng0)
    am, jam = lvcsr.synthetic_am_tri(task, device="cpu"), jlvcsr.synthetic_am_tri(jtask)
    tg = tk.build_token_graph(task.graph, device="cpu")
    sg = sd.build_split_graph(task.graph, a0=2, device="cpu")
    jtg = jtk.build_token_graph(jtask.graph)
    eg = sd.overflow_budget(sg, 192)
    assert eg == int(np.sort(sg.ov_count.numpy())[::-1][:192].sum())
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for sent in [s[:3] for s in text[:2]]:
        feats = lvcsr.synthesize_utterance_tri(task, sent, rng)
        assert feats.tobytes() == jlvcsr.synthesize_utterance_tri(jtask, sent, jrng).tobytes()
        ll = gmm.loglik(am, torch.as_tensor(feats))
        dense = tk.decode(tg, ll, kcap=192, beam=60.0)[0]
        split, _, _, overflow = sd.decode_split(sg, ll, kcap=192, beam=60.0, eg=eg)
        ref = jtk.decode_with_tokens(jtg, jgmm.loglik(jam, jnp.asarray(feats)), kcap=192,
                                     beam=60.0, select_mode="xla")[0]
        words = [[task.words.name(int(w)) for w in o if w] for o in (dense, split, ref)]
        assert int(overflow) == 0
        assert words == [sent, sent, sent], (sent, words)
