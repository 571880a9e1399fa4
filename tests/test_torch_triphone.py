"""Port parity: the triphone context-dependency build (`dsr_tpu_torch/asr/
triphone.py`) against the JAX package's `asr/triphone.py`: the C
transducer, H_tri over one tree (the JAX tree carried across by
`convert.distrib_tree`), `context_of_alignment`, and the full
`compose_hclg_tri` on the phone task (bigram G of the corpus text).

Tolerance: none.  The graphs are integer and float bookkeeping through the
same algorithms (the port's native core is a copy of the JAX package's),
so the arcs must be equal one for one and the packed arrays bit for bit.
"""

import numpy as np
import pytest

from _torch_parity import phone_pair, tree_alignments
from dsr_tpu.asr import tree as jtree
from dsr_tpu.asr import triphone as jtri
from dsr_tpu.asr.fsm import hclg as jhclg
from dsr_tpu.asr.fsm import lm as jlm
from dsr_tpu.asr.fsm.packed import pack as jpack
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr import triphone
from dsr_tpu_torch.asr.fsm import hclg, lm
from dsr_tpu_torch.asr.fsm.packed import pack
from dsr_tpu_torch.utils import corpus


@pytest.fixture(scope="module")
def system():
    """(JAX task, port task, JAX tree, port tree) over the phone task."""
    jtask, task = phone_pair()
    frames, feats, seqs = tree_alignments(40, seed=3)
    jt = jtree.build_tree(jtree.accumulate_tree_stats(frames, feats, seqs, 2),
                          min_gain=30.0, min_count=20.0)
    return jtask, task, jt, convert.distrib_tree(jt)


def _arcs(f):
    return (f.start, sorted(f.finals.items()),
            [[tuple(a) for a in lst] for lst in f.arcs])


def _same_packed(g, jg):
    assert (g.start, g.num_states) == (jg.start, jg.num_states)
    for name in ("src", "pdf", "olabel", "dst", "weight", "final_weight"):
        a, b = np.asarray(getattr(g, name)), np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_context_fst_and_hmm_fst_match_jax(system):
    jtask, task, jt, t = system
    for ndis in (0, 2):
        C, tbl = triphone.build_context_fst(task.phones, ndis)
        jC, jtbl = jtri.build_context_fst(jtask.phones, ndis)
        assert _arcs(C) == _arcs(jC) and tbl.num_tri == jtbl.num_tri
        assert tbl.disambig(ndis or 1) == jtbl.disambig(ndis or 1)
        seen = list(range(1, tbl.num_tri + 1, 7))
        assert all(tbl.untri(s) == jtbl.untri(s) and tbl.tri(*tbl.untri(s)) == s for s in seen)
        H = triphone.build_hmm_fst_tri(tbl, t, task.phones, ndis, task.spp, seen_tris=seen)
        jH = jtri.build_hmm_fst_tri(jtbl, jt, jtask.phones, ndis, jtask.spp, seen_tris=seen)
        assert _arcs(H) == _arcs(jH)
    # tests/test_triphone.py's path: tri(sil,a,b) tri(a,b,sil) is accepted
    a, b, sil = (task.phones[p] for p in ("aa", "sh", "sil"))
    assert C.path_weight([tbl.tri(sil, a, b), tbl.tri(a, b, sil)]) < float("inf")


def test_context_of_alignment_matches_jax():
    rng = np.random.default_rng(4)
    for n_phones in (3, 9):
        segs, t0 = [], 0
        for k in range(n_phones * 2):
            n = int(rng.integers(1, 6))
            segs.append((int(rng.integers(0, 40)) * 2 + k % 2, t0, t0 + n))
            t0 += n
        for seq_len in (n_phones, n_phones - 1):
            assert (triphone.context_of_alignment(segs, seq_len, 2)
                    == jtri.context_of_alignment(segs, seq_len, 2))


def test_compose_hclg_tri_matches_jax(system):
    """The phone task's full triphone graph through compose_hclg_tri (the
    port's rmepsilon_input between the native ops), packed arrays equal."""
    jtask, task, jt, t = system
    texts = [ws for ws, _ in corpus.make_corpus(12, seed=0)]
    G = lm.arpa_to_fst(lm.train_arpa_bigram(texts, task.vocab), task.words)
    jG = jlm.arpa_to_fst(jlm.train_arpa_bigram(texts, jtask.vocab), jtask.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    jL, jndis = jhclg.build_lexicon_fst(jtask.lexicon, jtask.phones, jtask.words,
                                        sil_phone="sil")
    assert ndis == jndis
    g = pack(triphone.compose_hclg_tri(L, G, task.phones, t, ndis, task.spp))
    jg = jpack(jtri.compose_hclg_tri(jL, jG, jtask.phones, jt, jndis, jtask.spp))
    _same_packed(g, jg)
    assert g.num_arcs > 1000 and g.pdf.max() < t.num_leaves
