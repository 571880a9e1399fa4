"""Port parity: speaker adaptation (`dsr_tpu_torch/asr/adapt/{mllr,fmllr,
vtln}.py`) against the JAX package's, on tests/test_adapt_mmi_lattice.py's
recipes (a shifted speaker on the 6-word phone task), tests/test_mllr_
regclass.py's two-cluster model, and tests/test_vtln.py's warped speaker.
The phone task's GMMs are trained by the JAX package (9 utterances, 3
iterations) and carried across by `convert.gmm_params`; both packages get
the same occupancies (the port's forced alignment, equal to the JAX
package's: checked).

Tolerances, as max |a - b| over the largest |b| unless said otherwise:
  - global MLLR W: 2e-3.  Its float32 normal equations (one utterance,
    many Gaussians without data) put each package 3-4e-4 from the float64
    solution on this input; the gain gate (> 1 nat) is the reference's.
  - fMLLR statistics 1e-5 (float32 sums in another order, measured
    2.5e-7); the transform 5e-4 (the JAX package's float32 row updates
    are 6e-5 from float64 here, the port's 1e-5).
  - regression classes: the tree and the class of every Gaussian equal;
    the node transforms 5e-4 as |a - b| / (|b| + 1) (float64 solves of
    float32 statistics, measured 2e-4) where the node's normal equations
    have full rank (a node over fewer than D + 1 Gaussians is fixed only
    by the 1e-4 ridge: what it does to its own Gaussians is compared, in
    the adapted means); the adapted means 1e-4.
  - VTLN: the chosen warp equal; each warp's total alignment score within
    1e-3 relative (float32 log-likelihoods over ~2 x 150 frames, as
    tests/test_torch_path.py allows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import adapt_gamma, adapt_system, rel
from dsr_tpu.asr.adapt import fmllr as jfmllr
from dsr_tpu.asr.adapt import mllr as jmllr
from dsr_tpu.asr.adapt import vtln as jvtln
from dsr_tpu.asr.am import gmm as jgmm
from dsr_tpu.asr.train import ml as jml
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.adapt import fmllr, mllr, vtln
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.train import ml
from dsr_tpu_torch.utils import corpus



@pytest.fixture(scope="module")
def system():
    return adapt_system()


def _fit(p, f):
    return float(gmm.loglik(p, torch.as_tensor(f)).max(-1).values.sum())


def test_mllr_matches_jax(system):
    jtask, task, jp, p, feats, words = system
    shift = np.zeros(13, np.float32)
    shift[:4] = [2.0, -1.0, 0.8, 0.5]
    f = feats[0] + shift
    g = adapt_gamma(jtask, task, jp, p, f, words[0])
    acc = ml.accumulate(p, torch.as_tensor(f), torch.as_tensor(g),
                        ml.zero_accum(task.num_states, 2, 13))
    jacc = jml.accumulate(jp, jnp.asarray(f), jnp.asarray(g),
                          jml.zero_accum(task.num_states, 2, 13))
    W, jW = mllr.estimate_mllr(p, acc), jmllr.estimate_mllr(jp, jacc)
    assert W.shape == (13, 14) and rel(W.numpy(), jW) < 2e-3
    adapted = mllr.apply_mllr(p, convert.transform(jW))
    assert rel(adapted.means.numpy(), jmllr.apply_mllr(jp, jW).means) < 1e-6
    assert _fit(mllr.apply_mllr(p, W), f) > _fit(p, f) + 1.0


def test_fmllr_matches_jax(system):
    jtask, task, jp, p, feats, words = system
    shift = np.zeros(13, np.float32)
    shift[:3] = [1.5, -0.7, 0.6]
    f = feats[1] + shift
    g = adapt_gamma(jtask, task, jp, p, f, words[1])
    st = fmllr.accumulate_fmllr(p, torch.as_tensor(f), torch.as_tensor(g))
    jst = jfmllr.accumulate_fmllr(jp, jnp.asarray(f), jnp.asarray(g))
    for a, b in zip(st, jst):
        assert rel(a.numpy(), b) < 1e-5
    Wf, jWf = fmllr.estimate_fmllr(st, iters=5), jfmllr.estimate_fmllr(jst, iters=5)
    assert rel(Wf.numpy(), jWf) < 5e-4
    f2 = fmllr.apply_fmllr(torch.as_tensor(f), Wf).numpy()
    assert rel(f2, jfmllr.apply_fmllr(jnp.asarray(f), jWf)) < 5e-4
    assert _fit(p, f2) > _fit(p, f) + 1.0
    assert np.corrcoef(Wf[:, 13].numpy()[:3], -shift[:3])[0, 1] > 0.5


def test_mllr_regression_classes_match_jax():
    S, C, D = 24, 1, 4
    rng = np.random.default_rng(0)
    centers = np.asarray([[4.0, 4, 4, 4], [-4.0, -4, -4, -4]])
    mu = np.stack([centers[s % 2] + rng.normal(0, 1.0, D) for s in range(S)])
    jp = jgmm.GmmParams(jnp.asarray(mu[:, None, :].astype(np.float32)),
                        jnp.full((S, C, D), 0.5, jnp.float32), jnp.zeros((S, C), jnp.float32))
    p = convert.gmm_params(jp)
    group = np.arange(S) % 2
    shifts = np.asarray([[2.0, -1.0, 0.5, 1.5], [-1.5, 2.0, -0.5, -2.0]])
    for occ, n_leaves, min_occ in ((np.full(S, 200.0), 2, 50.0),
                                   (np.where(group == 0, 300.0, 2.0), 2, 50.0),
                                   (np.full(S, 200.0), 4, 10.0)):
        occ = occ.astype(np.float32)
        target = mu + shifts[group]
        stats = (occ[:, None], (occ[:, None] * target)[:, None].astype(np.float32),
                 (occ[:, None] * (target ** 2 + 0.5))[:, None].astype(np.float32))
        jacc = jml.GmmAccum(*(jnp.asarray(a) for a in stats))
        acc = ml.GmmAccum(*(torch.as_tensor(a) for a in stats))
        jtree = jmllr.build_regression_tree(jp, jacc.occ, n_leaves=n_leaves)
        tree = mllr.build_regression_tree(p, acc.occ, n_leaves=n_leaves)
        ctree = convert.regression_tree(jtree)
        for t in (tree, ctree):
            assert np.array_equal(t.leaf_of, jtree.leaf_of) and t.n_nodes == jtree.n_nodes
            assert np.array_equal(t.parent, jtree.parent)
        W_node, class_W = mllr.estimate_mllr_regclass(p, acc, tree, min_occ=min_occ)
        jW_node, jclass_W = jmllr.estimate_mllr_regclass(jp, jacc, jtree, min_occ=min_occ)
        assert np.array_equal(class_W.numpy(), np.asarray(jclass_W))
        # nodes over at least D + 1 Gaussians: their normal equations have
        # full rank (a leaf of 4 Gaussians leaves [1, mu] a null direction
        # that only the 1e-4 ridge fixes, and its W there is noise)
        under = np.zeros(tree.n_nodes, int)
        for leaf in tree.leaf_of:
            node = int(leaf)
            while node >= 0:
                under[node] += 1
                node = int(tree.parent[node])
        posed = under >= D + 1
        err = (np.abs(W_node.numpy()[posed] - np.asarray(jW_node)[posed])
               / (np.abs(np.asarray(jW_node)[posed]) + 1.0))
        assert float(err.max()) < 5e-4
        ad = mllr.apply_mllr_regclass(p, *convert.class_transforms(jW_node, jclass_W)).means
        jad = jmllr.apply_mllr_regclass(jp, jW_node, jclass_W).means
        assert rel(ad.numpy(), jad) < 1e-4
        assert rel(mllr.apply_mllr_regclass(p, W_node, class_W).means.numpy(), jad) < 1e-4


def test_vtln_warp_matches_jax(system, monkeypatch):
    """A speaker with every formant 10 % high (tests/test_vtln.py's), two
    utterances, five warps: the same scores and the same warp."""
    jtask, task, jp, p, _, _ = system
    warped = {ph: tuple(f * 1.1 for f in fs) for ph, fs in corpus.PHONES.items()}
    monkeypatch.setattr(corpus, "PHONES", warped)
    utts = [(ws, x) for ws, x in corpus.make_corpus(12, seed=200)
            if all(w in task.vocab for w in ws)][:2]
    monkeypatch.undo()
    warps = (0.85, 0.9, 0.95, 1.0, 1.05)
    xs, trans = [x for _, x in utts], [ws for ws, _ in utts]
    best, scores = vtln.estimate_warp(task, p, xs, trans, warps=warps)
    jbest, jscores = jvtln.estimate_warp(jtask, jp, xs, trans, warps=warps)
    assert best == jbest and list(scores) == list(jscores)
    for w in warps:
        assert abs(scores[w] - jscores[w]) <= 1e-3 * abs(jscores[w])
    assert best < 1.0
