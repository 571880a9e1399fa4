"""The port's dense decoder against itself: the streaming chunk API over
ragged chunks and the batched decode over ragged lengths, on the V=300
trigram graph (68,551 states), kcap 128, beam 60.

Tolerance: none.  The same float32 adds and the same exact selection in
the same order, so tokens, words and scores must be equal bit for bit.
"""

import numpy as np
import pytest
import torch

from _torch_parity import logliks, lvcsr_v300
from dsr_tpu_torch.asr.decoder import topk_decoder as tk

KCAP, BEAM, T = 128, 60.0, 200


@pytest.fixture(scope="module")
def graphs():
    task, g = lvcsr_v300()
    return task, None, tk.build_token_graph(g, "cpu")


def test_decode_chunk_over_ragged_chunks_equals_whole_decode(graphs):
    task, _, tg = graphs
    ll = logliks(np.random.default_rng(9), (T, task.num_pdfs), rounded=False)
    o, s, ts, ta, tsc = tk.decode_with_tokens(tg, ll, kcap=KCAP, beam=BEAM)
    carry = tk.stream_start(tg, KCAP)
    parts = []
    for lo, hi in ((0, 7), (7, 61), (61, 62), (62, T)):
        carry, toks = tk.decode_chunk(tg, ll[lo:hi], carry, KCAP, BEAM)
        parts.append(toks)
    for j, full in enumerate((ts, ta, tsc)):
        assert torch.equal(torch.cat([p[j] for p in parts]), full)
    oc, sc = tk.traceback(tg, torch.cat([p[0] for p in parts]),
                          torch.cat([p[1] for p in parts]), carry)
    assert torch.equal(oc, o) and torch.equal(sc, s)


def test_decode_batch_with_ragged_lengths_equals_single_decodes(graphs):
    task, _, tg = graphs
    lens = [T, 150, 90]
    ll = logliks(np.random.default_rng(11), (3, T, task.num_pdfs), rounded=False)
    o, s = tk.decode_batch(tg, ll, lens, kcap=KCAP, beam=BEAM)
    assert o.shape == (3, T) and s.shape == (3,)
    for u, n in enumerate(lens):
        o1, s1 = tk.decode(tg, ll[u], kcap=KCAP, beam=BEAM, length=n)
        assert torch.equal(o[u], o1) and torch.equal(s[u], s1)
        assert not o[u, n:].any()
