"""The port's lattice decode (`topk_decoder.decode_with_tokens(nlat=4)` and
the streamed `decode_chunk(nlat=4)`) against the JAX package's sort path
(`select_mode="xla"`) on the V=300 trigram graph (68,551 states), the same
graph carried across by `convert.packed_graph`, kcap 128, beam 60.

Tolerances, as tests/test_torch_decoder.py states them:
- log-likelihoods on a 2^-6 grid: the reference's hi/lo-bf16 acoustic
  lookup is exact, so words, token tables and alt arcs must be identical
  and token and alt scores equal to float32 rounding (1e-6 relative);
- raw log-likelihoods: the reference's lookup is off by up to 2^-17 of
  each term, so alternates may swap at near ties: words must be identical
  and the score within 1e-5 relative.
The streamed alt tables must equal the whole-utterance ones bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NEG, logliks, lvcsr_v300, words
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu_torch.asr.decoder import topk_decoder as tk

KCAP, BEAM, NLAT, T = 128, 60.0, 4, 120


@pytest.fixture(scope="module")
def graphs():
    task, g = lvcsr_v300()
    return task, jtk.build_token_graph(task.graph), tk.build_token_graph(g, "cpu")


def _both(graphs, ll):
    _, jtg, tg = graphs
    ref = [np.asarray(x) for x in jtk.decode_with_tokens(
        jtg, jnp.asarray(ll), kcap=KCAP, beam=BEAM, nlat=NLAT, select_mode="xla")]
    out = [x.numpy() for x in tk.decode_with_tokens(tg, ll, kcap=KCAP, beam=BEAM, nlat=NLAT)]
    return ref, out


def test_lattice_decode_is_identical_on_exact_lookups(graphs):
    task = graphs[0]
    ll = logliks(np.random.default_rng(31), (T, task.num_pdfs), rounded=True)
    (ro, rs, rts, rta, rtsc, raa, ras), (o, s, ts, ta, tsc, aa, asc) = _both(graphs, ll)
    assert words(o) == words(ro) and len(words(o)) > 0
    assert np.array_equal(ts, rts) and np.array_equal(ta, rta)
    np.testing.assert_allclose(tsc, rtsc, rtol=1e-6)
    np.testing.assert_allclose(s, rs, rtol=1e-6)
    assert aa.shape == (T, KCAP, NLAT) and asc.shape == (T, KCAP, NLAT)
    assert np.array_equal(aa, raa)
    assert (aa[..., 1:] >= 0).any()                      # real alternates, not just winners
    assert np.array_equal(asc <= NEG / 2, ras <= NEG / 2)
    np.testing.assert_allclose(np.where(asc > NEG / 2, asc, 0), np.where(ras > NEG / 2, ras, 0),
                               rtol=1e-6)
    # column 0 is the 1-best winner
    live = ta >= 0
    assert np.array_equal(aa[..., 0], ta)
    assert np.array_equal(asc[..., 0][live], tsc[live])


def test_lattice_decode_words_on_raw_logliks(graphs):
    task = graphs[0]
    ll = logliks(np.random.default_rng(32), (T, task.num_pdfs), rounded=False)
    (ro, rs, *_), (o, s, *_) = _both(graphs, ll)
    assert words(o) == words(ro)
    assert abs(float(s) - float(rs)) <= 1e-5 * abs(float(rs))


def test_streamed_lattice_equals_whole_utterance(graphs):
    task, _, tg = graphs
    ll = logliks(np.random.default_rng(33), (T, task.num_pdfs), rounded=False)
    o, s, *whole = tk.decode_with_tokens(tg, ll, kcap=KCAP, beam=BEAM, nlat=NLAT)
    carry = tk.stream_start(tg, KCAP)
    parts = []
    for lo, hi in ((0, 5), (5, 47), (47, 48), (48, T)):
        carry, toks = tk.decode_chunk(tg, ll[lo:hi], carry, KCAP, BEAM, nlat=NLAT)
        assert len(toks) == 5 and toks[3].shape == (hi - lo, KCAP, NLAT)
        parts.append(toks)
    for j, full in enumerate(whole):
        assert torch.equal(torch.cat([p[j] for p in parts]), full)
    oc, sc = tk.traceback(tg, torch.cat([p[0] for p in parts]),
                          torch.cat([p[1] for p in parts]), carry)
    assert torch.equal(oc, o) and torch.equal(sc, s)
