"""Port parity: the dense general-graph WFST decoder
(`dsr_tpu_torch/asr/decoder/wfst_decoder.py`) against the JAX package's
`wfst_decoder.decode` / `decode_batch`, on the phone task's bigram HCLG
(built by the JAX package from a handful of transcripts and carried across
with `dsr_tpu_torch.convert.packed_graph`), with log-likelihoods of a
seeded GMM on features of the synthetic corpus.

Tolerance: olabels and arc paths equal; scores within 1e-3 relative
(the same float32 sums per frame, over ~150 frames).
"""

import numpy as np
import torch

from _torch_parity import config1_corpus, gmm_pair, phone_pair
from dsr_tpu.asr.decoder import wfst_decoder as jwd
from dsr_tpu.asr.fsm import hclg as jhclg
from dsr_tpu.asr.fsm import lm as jlm
from dsr_tpu.asr.fsm.packed import pack as jpack
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr.am import gmm
from dsr_tpu_torch.asr.decoder import wfst_decoder as wd


def _system():
    jtask, task = phone_pair()
    feats, words = config1_corpus(4, seed=21)
    G = jlm.arpa_to_fst(jlm.train_arpa_bigram(words, jtask.vocab), jtask.words)
    L, ndis = jhclg.build_lexicon_fst(jtask.lexicon, jtask.phones, jtask.words, sil_phone="sil")
    P = len(jtask.phones) - 1
    H = jhclg.build_hmm_fst(P, ndis, states_per_phone=jtask.spp)
    g_j = jpack(jhclg.compose_hclg(H, L, G, P, ndis))
    _, p = gmm_pair(np.random.default_rng(21), task.num_pdfs)
    lls = [gmm.loglik(p, torch.as_tensor(f)).numpy() for f in feats]
    return g_j, task, lls


def test_decode_matches_jax():
    g_j, task, lls = _system()
    jgraph = jwd.to_device(g_j)
    graph = wd.to_device(convert.packed_graph(g_j), device="cpu")
    for ll in lls[:2]:
        ol_j, arcs_j, s_j = jwd.decode(jgraph, ll)
        ol, arcs, s = wd.decode(graph, torch.as_tensor(ll))
        assert np.array_equal(ol.numpy(), np.asarray(ol_j))
        assert np.array_equal(arcs.numpy(), np.asarray(arcs_j))
        assert abs(float(s) - float(s_j)) <= 1e-3 * abs(float(s_j))
        assert wd.words_from_olabels(ol, task.words) == jwd.words_from_olabels(
            np.asarray(ol_j), task.words)


def test_decode_batch_with_ragged_lengths_matches_jax():
    g_j, _, lls = _system()
    T = max(len(ll) for ll in lls)
    batch = np.stack([np.pad(ll, ((0, T - len(ll)), (0, 0))) for ll in lls])
    lens = np.array([len(ll) for ll in lls])
    ol_j, arcs_j, s_j = jwd.decode_batch(jwd.to_device(g_j), batch, lens)
    graph = wd.to_device(convert.packed_graph(g_j), device="cpu")
    ol, arcs, s = wd.decode_batch(graph, torch.as_tensor(batch), lens)
    assert np.array_equal(ol.numpy(), np.asarray(ol_j))
    assert np.array_equal(arcs.numpy(), np.asarray(arcs_j))
    assert np.all(np.abs(s.numpy() - np.asarray(s_j)) <= 1e-3 * np.abs(np.asarray(s_j)))
    assert np.all(arcs.numpy()[np.arange(T)[None, :] >= lens[:, None]] == -1)
