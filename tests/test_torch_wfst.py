"""The port's graph build (`dsr_tpu_torch.asr.fsm`, `asr/lvcsr.py`, its own
WFST core built from `asr/fsm/csrc/wfst.cpp`) against the JAX package's,
and the dense decoder's arc tables built from the same graph (the split
decoder's are checked in tests/test_torch_split_decoder.py).

The port's decode tests are split into files of at most three tests, so
that `--dist loadfile`, which hands out files with more tests first,
schedules them after the JAX package's files.

Tolerance: none.  The build is integer and float32 bookkeeping through the
same C++ algorithms, so every array must be equal, weights bit for bit.
"""

import numpy as np

from dsr_tpu.asr import lvcsr as jlvcsr
from dsr_tpu.asr import phone_task
from dsr_tpu.asr.decoder import topk_decoder as jtk
from dsr_tpu.asr.fsm import hclg as jhclg
from dsr_tpu.asr.fsm import lm as jlm
from dsr_tpu.asr.fsm.packed import pack as jpack
from dsr_tpu_torch import convert
from dsr_tpu_torch.asr import lvcsr
from dsr_tpu_torch.asr.decoder import topk_decoder as tk
from dsr_tpu_torch.asr.fsm import hclg, lm, native
from dsr_tpu_torch.asr.fsm.packed import pack
from dsr_tpu_torch.ops.cuda import build
from golden import corpus as gcorpus

V50 = dict(vocab_size=50, n_tokens=1000, branching=3)
FIELDS = ("src", "pdf", "olabel", "dst", "weight", "final_weight")


def _same_graph(g, jg):
    assert (g.start, g.num_states) == (jg.start, jg.num_states)
    for f in FIELDS:
        a, b = np.asarray(getattr(g, f)), np.asarray(getattr(jg, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        assert np.array_equal(a, b), f


def test_build_task_matches_jax(tmp_path, monkeypatch):
    """The V=50 trigram task (12,225 states, 30,581 arcs), built afresh by
    the port's native core (its own library, not native/libdsrnative.so)."""
    monkeypatch.setenv("DSR_TPU_TORCH_CACHE", str(tmp_path))
    task = lvcsr.build_task(lvcsr.LvcsrConfig(**V50))
    jtask = jlvcsr.build_task(jlvcsr.LvcsrConfig(**V50))
    assert lvcsr.LvcsrConfig(**V50).key() == jlvcsr.LvcsrConfig(**V50).key()
    assert (task.graph.num_states, task.graph.num_arcs) == (12225, 30581)
    _same_graph(task.graph, jtask.graph)
    assert task.words.id2name == jtask.words.id2name and task.lexicon == jtask.lexicon
    assert build.target("wfst").parent == build.BUILD_DIR
    assert native._load()._name == str(build.target("wfst"))
    # the cached copy loads back equal
    _same_graph(lvcsr.build_task(lvcsr.LvcsrConfig(**V50)).graph, jtask.graph)


def test_token_graph_tables_match_jax():
    jg = jlvcsr.build_task(jlvcsr.LvcsrConfig(**V50)).graph
    tg, jtg = tk.build_token_graph(convert.packed_graph(jg), "cpu"), jtk.build_token_graph(jg)
    assert (tg.start, tg.num_states, tg.a_max) == (int(jtg.start), jtg.num_states, jtg.a_max)
    for f in ("pdf", "olabel", "weight", "dst", "final_weight"):
        assert np.array_equal(getattr(tg, f).numpy(), np.asarray(getattr(jtg, f))), f


def test_wfst_compose_determinize_rmepsilon_match_jax():
    """The `Wfst`-level native ops through the H/L/G builders: a small
    phone task's HCLG with the early-label lexicon (disambiguation symbols)
    and the late-label one, and the ARPA bigram trainer's text."""
    task = phone_task.PhoneTask(gcorpus.VOCAB[:6], states_per_phone=2)
    # a homophone and a prefix word, so that L needs disambiguation symbols
    first = task.vocab[0]
    lexicon = {**task.lexicon, "homophone": task.lexicon[first],
               "prefix": task.lexicon[first][:1]}
    vocab = sorted(lexicon)
    phones = hclg.SymbolTable(task.phones.id2name[1:])
    words, jwords = hclg.SymbolTable(vocab), jhclg.SymbolTable(vocab)
    transcripts = [[w if w in task.vocab else "homophone" for w in ws]
                   for ws, _ in gcorpus.make_corpus(12, seed=0)]
    arpa = lm.train_arpa_bigram(transcripts, vocab)
    assert arpa == jlm.train_arpa_bigram(transcripts, vocab)
    G, jG = lm.arpa_to_fst(arpa, words), jlm.arpa_to_fst(arpa, jwords)
    P = len(phones) - 1
    L, ndis = hclg.build_lexicon_fst(lexicon, phones, words, sil_phone="sil")
    jL, jndis = jhclg.build_lexicon_fst(lexicon, task.phones, jwords, sil_phone="sil")
    assert ndis == jndis > 0
    H = hclg.build_hmm_fst(P, ndis, states_per_phone=2)
    jH = jhclg.build_hmm_fst(P, ndis, states_per_phone=2)
    g = pack(hclg.compose_hclg(H, L, G, P, ndis))
    _same_graph(g, jpack(jhclg.compose_hclg(jH, jL, jG, P, ndis)))
    assert g.num_states > 50
    Le, _ = hclg.build_lexicon_fst(lexicon, phones, words, sil_phone="sil", olabel_at="end")
    jLe, _ = jhclg.build_lexicon_fst(lexicon, task.phones, jwords, sil_phone="sil",
                                     olabel_at="end")
    H0, jH0 = hclg.build_hmm_fst(P, 0, 2), jhclg.build_hmm_fst(P, 0, 2)
    _same_graph(pack(H0.compose(Le.compose(G).determinize()).rmepsilon().connect()),
                jpack(jH0.compose(jLe.compose(jG).determinize()).rmepsilon().connect()))
