"""The port's dense top-K decoder (`dsr_tpu_torch.asr.decoder.topk_decoder`)
against the JAX package's sort path (`decode_with_tokens(select_mode=
"xla")`) on the V=300 trigram graph (68,551 states), the same graph
carried across by `convert.packed_graph`, kcap 128, beam 60.

Tolerances:
- log-likelihoods on a 2^-6 grid (|ll| < 2^9): the reference's hi/lo-bf16
  acoustic lookup is then exact, so words, token states and backpointers
  must be identical and token scores equal to float32 rounding (1e-6
  relative);
- raw log-likelihoods: the reference's lookup is off by up to 2^-17 of
  each term, so words must be identical and the final score within 1e-5
  relative (≤ |score|·2^-17 summed over the frames).

The port against itself (chunked, batched) is in
tests/test_torch_decode_chunks.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import logliks, lvcsr_v300, words
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu_torch.asr.decoder import topk_decoder as tk

KCAP, BEAM, T = 128, 60.0, 200


@pytest.fixture(scope="module")
def graphs():
    task, g = lvcsr_v300()
    return task, jtk.build_token_graph(task.graph), tk.build_token_graph(g, "cpu")


def _both(graphs, ll):
    _, jtg, tg = graphs
    ref = [np.asarray(x) for x in jtk.decode_with_tokens(
        jtg, jnp.asarray(ll), kcap=KCAP, beam=BEAM, select_mode="xla")]
    out = [x.numpy() for x in tk.decode_with_tokens(tg, ll, kcap=KCAP, beam=BEAM)]
    return ref, out


def test_dense_decode_is_identical_on_exact_lookups(graphs):
    task = graphs[0]
    for seed in range(3):
        ll = logliks(np.random.default_rng(seed), (T, task.num_pdfs), rounded=True)
        (ro, rs, rts, rta, rtsc), (o, s, ts, ta, tsc) = _both(graphs, ll)
        assert words(o) == words(ro) and len(words(o)) > 0
        assert np.array_equal(o, ro)
        assert np.array_equal(ts, rts) and np.array_equal(ta, rta)
        np.testing.assert_allclose(tsc, rtsc, rtol=1e-6)
        np.testing.assert_allclose(s, rs, rtol=1e-6)


def test_dense_decode_words_on_raw_logliks(graphs):
    task = graphs[0]
    for seed in range(3, 6):
        ll = logliks(np.random.default_rng(seed), (T, task.num_pdfs), rounded=False)
        (ro, rs, *_), (o, s, *_) = _both(graphs, ll)
        assert words(o) == words(ro)
        assert abs(float(s) - float(rs)) <= 1e-5 * abs(float(rs))


def test_exact_select_never_spills_and_lattice_column_zero_is_the_one_best(graphs):
    task, _, tg = graphs
    ll = logliks(np.random.default_rng(12), (20, task.num_pdfs), rounded=False)
    spill = tk.decode_with_tokens(tg, ll, kcap=KCAP, beam=BEAM, return_spill=True)[-1]
    assert spill.shape == (20,) and not spill.any()
    assert not tk.decode_batch(tg, ll[None], [20], kcap=KCAP, return_spill=True)[2].any()
    o, s, ts, ta, tsc = tk.decode_with_tokens(tg, ll, kcap=KCAP, beam=BEAM)
    lo, ls, lts, lta, ltsc, aa, asc, lspill = tk.decode_with_tokens(
        tg, ll, kcap=KCAP, beam=BEAM, nlat=4, return_spill=True)
    assert lspill.shape == (20,) and not lspill.any()
    assert torch.equal(lo, o) and torch.equal(ls, s)
    assert torch.equal(lts, ts) and torch.equal(lta, ta) and torch.equal(ltsc, tsc)
    assert aa.shape == (20, KCAP, 4) and torch.equal(aa[..., 0], ta)
    live = ta >= 0
    assert torch.equal(asc[..., 0][live], tsc[live])
    carry, toks = tk.decode_chunk(tg, ll, tk.stream_start(tg, KCAP), KCAP, BEAM, nlat=4,
                                  return_spill=True)
    assert len(toks) == 6 and not toks[-1].any() and torch.equal(toks[3], aa)
