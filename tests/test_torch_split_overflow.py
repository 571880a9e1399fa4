"""The port's degree-split decoder on the V=300 trigram graph (68,551
states) at a0 = 2: its tokens against the port's dense decoder, its
overflow rule against the JAX `decode_split` (the Pallas select in
interpret mode) where the group budget overflows, and its batching.

Tolerances: tokens bit for bit against the port's dense decoder (the same
float32 adds in the same order); overflow counts and words exact; scores to
float32 rounding (1e-6 relative) against the JAX package on log-likelihoods
on a 2^-6 grid, where its bf16 hi/lo acoustic lookup is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import logliks, lvcsr_v300
from dsr_tpu.asr.decoder import split_decoder as jsd
from dsr_tpu_torch.asr.decoder import split_decoder as sd
from dsr_tpu_torch.asr.decoder import topk_decoder as tk

KCAP, BEAM, EG, T = 128, 60.0, 896, 200


@pytest.fixture(scope="module")
def graphs():
    task, g = lvcsr_v300()
    return task, g, sd.build_split_graph(g, a0=2, device="cpu")


def _arc_scores(weight, pdf, src, states0, scores0, tok_states, tok_scores, arcs, ll):
    """Each live backpointer's candidate score: its source token's score at
    the previous frame + the arc's weight + its pdf's log-likelihood."""
    T, U, _ = arcs.shape
    out = []
    for t in range(T):
        for u in range(U):
            a = arcs[t, u][arcs[t, u] >= 0].long()
            prev_st = states0[u] if t == 0 else tok_states[t - 1, u]
            prev_sc = scores0[u] if t == 0 else tok_scores[t - 1, u]
            k = (prev_st[None, :] == src(a)[:, None]).int().argmax(dim=1)
            out.append(prev_sc[k] + weight[a] + ll[u, t, pdf[a]])
    return torch.cat(out)


def test_split_tokens_equal_dense_tokens_without_overflow(graphs):
    """Token states and scores bit for bit.  The two tables number arcs
    differently, so where two arcs into a state tie exactly, "smallest arc
    id" picks different ones: every backpointer of both decoders must be an
    arc whose candidate score is its token's score, and they differ only at
    such ties (rare)."""
    task, g, sg = graphs
    tg = tk.build_token_graph(g, "cpu")
    ll = torch.as_tensor(logliks(np.random.default_rng(22), (2, T, task.num_pdfs), False))
    runs = []
    for expand, graph in ((lambda s, sc, x: sd.candidates(sg, s, sc, x, EG), sg),
                          (lambda s, sc, x: tk.candidates(tg, s, sc, x), tg)):
        states, scores = tk.start_tokens(graph, 2, KCAP)
        runs.append(tk.token_pass(expand, ll, [T, T], states, scores, BEAM, KCAP))
    assert not torch.stack([x[0] for x in runs[0][5]]).any()      # no overflow
    (s_states, s_arcs, s_scores), (d_states, d_arcs, d_scores) = runs[0][2:5], runs[1][2:5]
    assert torch.equal(s_states, d_states) and torch.equal(s_scores, d_scores)
    assert torch.equal(s_arcs < 0, d_arcs < 0)
    states0, scores0 = tk.start_tokens(tg, 2, KCAP)
    live = s_scores[s_arcs >= 0]
    a0, S = sg.a0, sg.num_states
    s_weight = torch.cat([sg.weight, sg.ov_weight[:sg.num_groups]]).reshape(-1)
    s_pdf = torch.cat([sg.pdf, sg.ov_pdf[:sg.num_groups]]).reshape(-1)
    assert S * a0 == sg.weight.numel()
    assert torch.equal(_arc_scores(s_weight, s_pdf, lambda a: sg.src_of_row[a // a0], states0,
                                   scores0, s_states, s_scores, s_arcs, ll), live)
    assert torch.equal(_arc_scores(tg.weight.reshape(-1), tg.pdf.reshape(-1),
                                   lambda a: (a // tg.a_max).int(), states0, scores0,
                                   d_states, d_scores, d_arcs, ll), live)
    s_src = sg.src_of_row[s_arcs.clamp(min=0).long() // a0]
    d_src = (d_arcs.clamp(min=0) // tg.a_max).int()
    assert int((s_src != d_src).sum()) < 0.01 * live.numel()


def test_overflow_count_and_drop_rule_match_jax_decode_split(graphs):
    """eg = 8 group slots cannot hold a frame's demand: the highest-indexed
    tokens lose their extra groups, as in the JAX package, whose select runs
    exactly here (spill 0)."""
    task, _, sg = graphs
    ll = logliks(np.random.default_rng(23), (16, task.num_pdfs), rounded=True)
    ro, rs, rspill, rovf = jsd.decode_split(jsd.build_split_graph(task.graph, a0=2),
                                            jnp.asarray(ll), kcap=KCAP, beam=BEAM, eg=8)
    assert int(rspill) == 0 and int(rovf) > 0
    o, s, spill, ovf = sd.decode_split(sg, ll, kcap=KCAP, beam=BEAM, eg=8)
    assert int(ovf) == int(rovf) and int(spill) == 0
    assert np.array_equal(o.numpy(), np.asarray(ro))
    np.testing.assert_allclose(float(s), float(rs), rtol=1e-6)


def test_decode_batch_split_with_ragged_lengths_equals_single_decodes(graphs):
    task, _, sg = graphs
    lens = [T, 120, 64]
    ll = logliks(np.random.default_rng(24), (3, T, task.num_pdfs), rounded=False)
    o, s, spill, ovf = sd.decode_batch_split(sg, ll, lens, kcap=KCAP, beam=BEAM, eg=64)
    assert o.shape == (3, T) and s.shape == spill.shape == ovf.shape == (3,)
    for u, n in enumerate(lens):
        o1, s1, _, ovf1 = sd.decode_split(sg, ll[u], kcap=KCAP, beam=BEAM, length=n, eg=64)
        assert torch.equal(o[u], o1) and torch.equal(s[u], s1) and int(ovf[u]) == int(ovf1)
