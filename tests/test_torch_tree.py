"""Port parity: the decision tree (`dsr_tpu_torch/asr/tree.py`) against the
JAX package's `asr/tree.py`, and `convert.distrib_tree`.

Inputs: seeded left-to-right alignments of the synthetic corpus's phone
sequences with float32 features (as `force_align` and MFCC give them),
and the LVCSR task's analytic statistics with noise added, where many
questions' gains lie close together.

Tolerance: none.  The statistics are float64 sums in the same order, so
they must be equal bit for bit and in the same key order, and the trees
equal node for node (question, leaf id): the port's tree against the JAX
tree carried across by `convert.distrib_tree` (dataclass equality), and
the carried tree's lookups against the JAX tree's.
"""

import numpy as np

from _torch_parity import tree_alignments
from dsr_tpu.asr import lvcsr as jlvcsr
from dsr_tpu.asr import tree as jtree
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr import tree
from dsr_tpu_torch.utils import corpus


def test_tree_stats_and_leaves_match_jax():
    frames, feats, seqs = tree_alignments(40, seed=3)
    stats = tree.accumulate_tree_stats(frames, feats, seqs, 2)
    jstats = jtree.accumulate_tree_stats(frames, feats, seqs, 2)
    assert list(stats) == list(jstats)
    for key, (n, sx, sxx) in jstats.items():
        assert stats[key][0] == n
        assert np.array_equal(stats[key][1], sx) and np.array_equal(stats[key][2], sxx)
    for kw in (dict(min_gain=30.0, min_count=20.0), dict(min_gain=5.0, min_count=2.0),
               dict(min_gain=5.0, min_count=2.0, max_leaves=40)):
        t = tree.build_tree(stats, **kw)
        jt = jtree.build_tree(jstats, **kw)
        assert t == convert.distrib_tree(jt)
        assert t.num_leaves > len(t.roots) // 2
        phones = sorted(corpus.PHONES) + ["sil"]
        for ctx in [(l, c, r, p) for l in phones for c in phones[:4] for r in phones
                    for p in (0, 1)]:
            assert t.lookup(*ctx) == jt.lookup(*ctx)


def test_tree_on_lvcsr_questions_and_convert():
    """The LVCSR questions (18 per node) on analytic statistics with noise,
    and the JAX tree carried across by `convert.distrib_tree`."""
    rng = np.random.default_rng(5)
    phones = jlvcsr.SymbolTable(jlvcsr.PHONE_INVENTORY + ["sil"])
    P, spp = len(phones) - 1, 3
    stats = {}
    for _ in range(1500):
        l, c, r = (int(x) for x in rng.integers(1, P + 1, 3))
        names = (phones.name(l), phones.name(c), phones.name(r))
        for pos in range(spp):
            m = jlvcsr._tri_mean(phones, spp, names[0], c, pos).astype(np.float64)
            m = m + 0.3 * rng.standard_normal(m.shape)
            n0 = float(rng.integers(5, 200))
            stats[(*names, pos)] = [n0, n0 * m, n0 * (0.25 + m * m)]
    kw = dict(questions=jlvcsr.TRI_QUESTIONS, min_gain=50.0, min_count=10.0, max_leaves=4000)
    t, jt = tree.build_tree(stats, **kw), jtree.build_tree(stats, **kw)
    c = convert.distrib_tree(jt)
    assert isinstance(c, tree.DistribTree) and c.questions == jt.questions
    assert list(c.roots) == list(jt.roots) and c.num_leaves == jt.num_leaves
    names = [phones.name(i) for i in range(1, P + 1)]
    for ctx in [(l, ce, r, pos) for l in names for ce in names[::7] for r in names[::3]
                for pos in range(spp)]:
        assert c.lookup(*ctx) == jt.lookup(*ctx)
    assert t == c                       # node for node (dataclass equality)
    assert t.num_leaves > 2 * len(t.roots)
