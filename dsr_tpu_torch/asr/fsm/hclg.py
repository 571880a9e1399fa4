"""H/C/L/G builders and the composed decoding graph.

The port's copy of `dsr_tpu/asr/fsm/hclg.py`: builders for H (HMM
topology), L (pronunciation lexicon), G (unigram word loop; ARPA n-grams
are in `lm.py`), the direct LG constructor, and the composed HCLG.
Monophone context (C = identity), configurable n-states-per-phone
left-to-right HMM topology.

Label spaces:
  - phones: 1..P (0 = eps), disambiguation symbols appended after P
  - words:  1..V (0 = eps)
  - H input labels: pdf ids + 1 (0 = eps); pdf id = (phone-1)*n_states + k

Recipe: LG = det(L ∘ G);  HCLG = rmeps(H_selfloop ∘ LG).connect()
(the decoder needs every arc to consume a frame, so epsilon removal runs
last).
"""

from __future__ import annotations

import math
from collections import defaultdict

from dsr_tpu_torch.asr.fsm.wfst import EPS, Wfst


class SymbolTable:
    def __init__(self, names: list[str]):
        self.id2name = ["<eps>"] + list(names)
        self.name2id = {n: i for i, n in enumerate(self.id2name)}

    def __getitem__(self, name: str) -> int:
        return self.name2id[name]

    def name(self, i: int) -> str:
        return self.id2name[i]

    def __len__(self):
        return len(self.id2name)


def build_lexicon_fst(
    lexicon: dict[str, tuple[str, ...]],
    phones: SymbolTable,
    words: SymbolTable,
    sil_phone: str | None = "sil",
    sil_prob: float = 0.5,
    olabel_at: str = "start",
) -> tuple[Wfst, int]:
    """L: phone strings → words, with optional inter-word silence and
    auto-inserted disambiguation symbols for homophones/prefixes.

    Returns (L, num_disambig).  Disambig phone ids are P+1 .. P+num_disambig
    (they pass through H as epsilon-like and are stripped before packing).

    olabel_at: "start" (default) emits the word id on the FIRST phone arc —
    the reference convention, earliest word identity.  "end" emits it on the
    LAST phone arc and skips disambiguation entirely: under pair-encoded
    (ilabel, olabel) determinization, late labels let det share pronunciation
    prefixes ACROSS words, bounding every state's out-degree by the phone
    inventory instead of the vocabulary — the property that keeps the packed
    LVCSR decoding graph's per-state arc rows narrow (see asr/lvcsr.py).
    Homophones stay distinct via their distinct olabels (no disambig needed).
    """
    if olabel_at == "end":
        return _build_lexicon_fst_end(lexicon, phones, words, sil_phone, sil_prob), 0
    if olabel_at != "start":
        raise ValueError(f"olabel_at must be 'start' or 'end'; got {olabel_at!r}")
    # --- assign disambig symbols (Kaldi add_lex_disambig logic, simplified)
    prons = list(lexicon.items())
    counts = defaultdict(int)
    for _, pron in prons:
        counts[pron] += 1
    prefixes = set()
    for _, pron in prons:
        for i in range(1, len(pron)):
            prefixes.add(pron[:i])
    disambig_of = {}
    next_id = defaultdict(int)
    max_disambig = 0
    for w, pron in prons:
        if counts[pron] > 1 or pron in prefixes:
            next_id[pron] += 1
            disambig_of[w] = next_id[pron]
            max_disambig = max(max_disambig, next_id[pron])
    P = len(phones) - 1

    def dis_id(k: int) -> int:
        return P + k  # symbol ids P+1.. (k>=1)

    L = Wfst()
    loop = L.add_state()
    L.set_start(loop)
    L.set_final(loop, 0.0)
    sil_cost = -math.log(sil_prob) if sil_phone else 0.0
    nosil_cost = -math.log(1.0 - sil_prob) if sil_phone else 0.0
    for w, pron in prons:
        cur = loop
        syms = [phones[p] for p in pron]
        if w in disambig_of:
            syms.append(dis_id(disambig_of[w]))
        for i, ph in enumerate(syms):
            nxt = L.add_state() if i + 1 < len(syms) else None
            olab = words[w] if i == 0 else EPS
            if nxt is not None:
                L.add_arc(cur, ph, olab, 0.0, nxt)
                cur = nxt
            else:
                # last phone: optionally go through silence back to loop
                end = L.add_state()
                L.add_arc(cur, ph, olab, 0.0, end)
                L.add_arc(end, EPS, EPS, nosil_cost, loop)
                if sil_phone:
                    L.add_arc(end, phones[sil_phone], EPS, sil_cost, loop)
    # optional leading silence
    if sil_phone:
        L.add_arc(loop, phones[sil_phone], EPS, 0.0, loop)
    return L, max_disambig


def _build_lexicon_fst_end(
    lexicon: dict[str, tuple[str, ...]],
    phones: SymbolTable,
    words: SymbolTable,
    sil_phone: str | None,
    sil_prob: float,
) -> Wfst:
    """Late-label lexicon (see build_lexicon_fst olabel_at="end")."""
    L = Wfst()
    loop = L.add_state()
    L.set_start(loop)
    L.set_final(loop, 0.0)
    sil_cost = -math.log(sil_prob) if sil_phone else 0.0
    nosil_cost = -math.log(1.0 - sil_prob) if sil_phone else 0.0
    for w, pron in lexicon.items():
        cur = loop
        syms = [phones[p] for p in pron]
        for i, ph in enumerate(syms):
            last = i + 1 == len(syms)
            olab = words[w] if last else EPS
            nxt = L.add_state()
            L.add_arc(cur, ph, olab, 0.0, nxt)
            cur = nxt
        L.add_arc(cur, EPS, EPS, nosil_cost, loop)
        if sil_phone:
            L.add_arc(cur, phones[sil_phone], EPS, sil_cost, loop)
    if sil_phone:
        L.add_arc(loop, phones[sil_phone], EPS, 0.0, loop)
    return L


def build_lg_fst(
    lexicon: dict[str, tuple[str, ...]],
    phones: SymbolTable,
    words: SymbolTable,
    G: Wfst,
    sil_phone: str | None = "sil",
    sil_prob: float = 0.5,
) -> Wfst:
    """Direct LG construction (late word labels), the LVCSR-scale path.

    Generic composition of a late-label L with G explores the full lexicon
    trie under EVERY G state and lets connect() prune the dead ends —
    O(|trie|·|G|) work for an O(output)-sized result (measured: 300 s for a
    2k-word trigram vs ~5 s here).  This builder materialises the reachable
    structure directly: per G state, a prefix trie of exactly the words on
    its outgoing arcs, with the word olabel + LM weight on the LAST phone
    arc and optional post-word silence.  G's eps (back-off) arcs and final
    weights carry over verbatim; the result equals connect(compose(L, G))
    up to state numbering and is already input-deterministic per (il, ol)
    pair at every trie node.
    """
    LG = Wfst()
    # one trie root per G state; roots numbered first so G arcs map directly
    roots = [LG.add_state() for _ in range(G.num_states)]
    LG.set_start(roots[G.start])
    for g, fw in G.finals.items():
        LG.set_final(roots[g], fw)
    sil_cost = -math.log(sil_prob) if sil_phone else 0.0
    nosil_cost = -math.log(1.0 - sil_prob) if sil_phone else 0.0
    sil_id = phones[sil_phone] if sil_phone else None

    def post_state(g_dst: int) -> int:
        """Shared per-destination post-word state: optional silence, then
        the destination root."""
        key = ("post", g_dst)
        s = post_cache.get(key)
        if s is None:
            s = LG.add_state()
            post_cache[key] = s
            LG.add_arc(s, EPS, EPS, nosil_cost, roots[g_dst])
            if sil_id is not None:
                LG.add_arc(s, sil_id, EPS, sil_cost, roots[g_dst])
        return s

    post_cache: dict = {}
    for g in range(G.num_states):
        if sil_id is not None:  # leading/inter-word silence self-loop
            LG.add_arc(roots[g], sil_id, EPS, 0.0, roots[g])
        trie: dict[tuple[int, ...], int] = {(): roots[g]}
        for a in G.arcs[g]:
            if a.ilabel == EPS:  # back-off arc: eps between roots
                LG.add_arc(roots[g], EPS, EPS, a.weight, roots[a.nextstate])
                continue
            word = words.name(a.ilabel)
            pron = lexicon.get(word)
            if pron is None:
                continue  # OOV word in G: unreachable
            syms = tuple(phones[p] for p in pron)
            cur = roots[g]
            for i in range(len(syms) - 1):
                prefix = syms[: i + 1]
                nxt = trie.get(prefix)
                if nxt is None:
                    nxt = LG.add_state()
                    trie[prefix] = nxt
                    LG.add_arc(cur, syms[i], EPS, 0.0, nxt)
                cur = nxt
            # last phone: emit word + LM cost, then optional silence
            LG.add_arc(cur, syms[-1], a.olabel, a.weight, post_state(a.nextstate))
    return LG


def build_unigram_g(
    words: SymbolTable, logprobs: dict[str, float] | None = None,
    word_penalty: float = 0.0
) -> Wfst:
    """Word-loop G (unigram): one state, arc per word with -log prob
    (+ optional per-word insertion penalty)."""
    G = Wfst()
    s = G.add_state()
    G.set_start(s)
    G.set_final(s, 0.0)
    V = len(words) - 1
    for w, i in words.name2id.items():
        if i == EPS:
            continue
        cost = (-logprobs[w] if logprobs else math.log(V)) + word_penalty
        G.add_arc(s, i, i, cost, s)
    return G


def build_hmm_fst(
    num_phones: int,
    num_disambig: int,
    states_per_phone: int = 3,
    self_lp: float = math.log(0.6),
) -> Wfst:
    """H (with self-loops): pdf-id sequences → phone sequences.

    Input labels: pdf+1 with pdf = (phone-1)*states_per_phone + k.
    Disambiguation symbols pass through as eps-input arcs (removed by the
    final rmepsilon).
    """
    adv = math.log1p(-math.exp(self_lp))
    H = Wfst()
    loop = H.add_state()
    H.set_start(loop)
    H.set_final(loop, 0.0)
    for ph in range(1, num_phones + 1):
        cur = loop
        for k in range(states_per_phone):
            pdf = (ph - 1) * states_per_phone + k
            nxt = H.add_state()
            # entry arc consumes the state's pdf; k>0 entries charge the
            # previous state's advance probability
            H.add_arc(cur, pdf + 1, ph if k == 0 else EPS, 0.0 if k == 0 else -adv, nxt)
            H.add_arc(nxt, pdf + 1, EPS, -self_lp, nxt)  # self-loop
            cur = nxt
        H.add_arc(cur, EPS, EPS, -adv, loop)  # exit charges last advance
    # disambig pass-through
    for d in range(1, num_disambig + 1):
        H.add_arc(loop, EPS, num_phones + d, 0.0, loop)
    return H


def compose_hclg(H: Wfst, L: Wfst, G: Wfst, num_phones: int, num_disambig: int) -> Wfst:
    """HCLG = rmeps(H ∘ strip_disambig(det(L ∘ G))).connect().arcsort()."""
    LG = L.compose(G).determinize()
    HLG = H.compose(LG)
    # strip disambig olabels? disambig live on the *input* (phone) side of LG;
    # H maps them to eps output already.  Remaining eps:eps arcs removed:
    out = HLG.rmepsilon().connect()
    out.arcsort("ilabel")
    return out
