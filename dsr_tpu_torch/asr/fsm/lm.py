"""ARPA n-gram language models → G transducer.

The port's copy of `dsr_tpu/asr/fsm/lm.py`: an ARPA reader with back-off
arcs as epsilon transitions (one state per n-gram history; word arcs move
to the extended/backed-off history with weight -ln p; back-off arcs are
eps:eps with the back-off weight), and the small ARPA trainers/writers
(absolute discounting) that the synthetic tasks use.
"""

from __future__ import annotations

import math
from collections import defaultdict

from dsr_tpu_torch.asr.fsm.hclg import SymbolTable
from dsr_tpu_torch.asr.fsm.wfst import EPS, Wfst

LN10 = math.log(10.0)


def parse_arpa(text: str) -> dict[int, dict[tuple[str, ...], tuple[float, float]]]:
    """ARPA text → {order: {ngram words: (log10 prob, log10 backoff)}}."""
    grams: dict[int, dict] = {}
    section = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("\\end"):
            continue
        if line.startswith("\\data"):
            section = None
            continue
        if line.startswith("\\") and "-grams:" in line:
            section = int(line[1 : line.index("-")])
            grams[section] = {}
            continue
        if section is None or line.startswith("ngram"):
            continue
        parts = line.split()
        lp = float(parts[0])
        words = tuple(parts[1 : 1 + section])
        bow = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
        grams[section][words] = (lp, bow)
    return grams


def arpa_to_fst(text: str, words: SymbolTable, bos="<s>", eos="</s>",
                word_penalty: float = 0.0) -> Wfst:
    """ARPA n-gram → G over the tropical semiring (weights -ln p).

    word_penalty: constant added per word arc (the classic insertion
    penalty decoder knob).
    """
    grams = parse_arpa(text)
    order = max(grams)
    G = Wfst()
    # state per history (tuple of words, len < order); () = unigram/backoff
    states: dict[tuple[str, ...], int] = {}

    def st(hist: tuple[str, ...]) -> int:
        while hist and hist not in _valid_hists:
            hist = hist[1:]
        if hist not in states:
            states[hist] = G.add_state()
        return states[hist]

    # valid histories = ngrams of order < max that have a backoff entry
    # (or any seen ngram of order < max)
    _valid_hists = {()} | {
        g for o in range(1, order) for g in grams.get(o, {})
    }
    start = st((bos,) if (bos,) in _valid_hists else ())
    G.set_start(start)
    for o in range(1, order + 1):
        for gram, (lp10, bow10) in grams[o].items():
            w = gram[-1]
            hist = gram[:-1]
            cost = -lp10 * LN10
            src = st(hist)
            if w == eos:
                # final weight at the history state
                cur = G.final_weight(src)
                G.set_final(src, min(cur, cost))
                continue
            if w == bos:
                continue
            nxt_hist = gram if o < order else gram[1:]
            dst = st(nxt_hist)
            wid = words[w]
            G.add_arc(src, wid, wid, cost + word_penalty, dst)
            # back-off arc out of the *new* history
            if o < order and bow10 != 0.0:
                G.add_arc(st(gram), EPS, EPS, -bow10 * LN10, st(gram[1:]))
    # histories without explicit backoff entries still need escape arcs
    for hist, s in list(states.items()):
        if hist and not G.arcs[s]:
            G.add_arc(s, EPS, EPS, 0.0, st(hist[1:]))
    return G.connect()


def train_arpa_ngram(
    transcripts: list[list[str]], vocab: list[str], order: int = 3,
    discount: float = 0.5,
) -> str:
    """Absolute-discount back-off n-gram → ARPA text (reference `asr/lm/`
    consumed externally-trained ARPA files; this writer generates synthetic
    ones at LVCSR scale so the reader/G-builder can be exercised without a
    corpus in the environment).

    Simple (non-interpolated) absolute discounting: p(w|h) = (c(hw)-D)/c(h)
    at every order, back-off weight bow(h) = log10(D·N1+(h·)/c(h)) for any
    history h that continues.  Not Kneser-Ney-exact — numerically sensible
    and properly structured for `arpa_to_fst`.
    """
    counts: list[dict] = [defaultdict(int) for _ in range(order + 1)]
    for ws in transcripts:
        seq = ["<s>"] + list(ws) + ["</s>"]
        for o in range(1, order + 1):
            for i in range(len(seq) - o + 1):
                g = tuple(seq[i : i + o])
                if o == 1 and g == ("<s>",):
                    continue
                counts[o][g] += 1
    vocab_all = sorted(set(vocab) | {"</s>"})
    total = sum(counts[1].values())
    # context stats per history (for discounted probs and bows)
    ctx_count: dict[tuple, int] = defaultdict(int)
    ctx_types: dict[tuple, int] = defaultdict(int)
    for o in range(2, order + 1):
        for g, c in counts[o].items():
            ctx_count[g[:-1]] += c
            ctx_types[g[:-1]] += 1

    def bow10(hist: tuple) -> float | None:
        if ctx_types.get(hist):
            return math.log10(discount * ctx_types[hist] / ctx_count[hist])
        return None

    lines = ["\\data\\"]
    lines.append(f"ngram 1={len(vocab_all) + 1}")
    for o in range(2, order + 1):
        lines.append(f"ngram {o}={len(counts[o])}")
    lines.append("")
    lines.append("\\1-grams:")
    b = bow10(("<s>",))
    lines.append(f"-99\t<s>\t{b if b is not None else 0.0:.6f}")
    for w in vocab_all:
        p = max(counts[1].get((w,), 0) - discount, 0.25) / total
        b = bow10((w,))
        tail = f"\t{b:.6f}" if b is not None else ""
        lines.append(f"{math.log10(p):.6f}\t{w}{tail}")
    for o in range(2, order + 1):
        lines.append("")
        lines.append(f"\\{o}-grams:")
        for g in sorted(counts[o]):
            c = counts[o][g]
            p = max(c - discount, 1e-4) / ctx_count[g[:-1]]
            b = bow10(g) if o < order else None
            tail = f"\t{b:.6f}" if b is not None else ""
            lines.append(f"{math.log10(p):.6f}\t{' '.join(g)}{tail}")
    lines.append("")
    lines.append("\\end\\")
    return "\n".join(lines)


def train_arpa_bigram(
    transcripts: list[list[str]], vocab: list[str], discount: float = 0.5
) -> str:
    """Absolute-discount interpolated bigram → ARPA text (for tests)."""
    uni = defaultdict(int)
    bi = defaultdict(int)
    for ws in transcripts:
        seq = ["<s>"] + list(ws) + ["</s>"]
        for w in seq[1:]:
            uni[w] += 1
        for a, b in zip(seq[:-1], seq[1:]):
            bi[(a, b)] += 1
    total = sum(uni.values())
    vocab_all = sorted(set(vocab) | {"</s>"})
    # unigram probs (with <unk>-free closed vocab; floor for unseen)
    p_uni = {w: max(uni[w], 0.5) / (total + 0.5 * len(vocab_all)) for w in vocab_all}
    lines = ["\\data\\"]
    lines.append(f"ngram 1={len(vocab_all) + 1}")
    n_bi = len(bi)
    lines.append(f"ngram 2={n_bi}")
    lines.append("")
    lines.append("\\1-grams:")
    ctx_counts = defaultdict(int)
    ctx_types = defaultdict(int)
    for (a, b), c in bi.items():
        ctx_counts[a] += c
        ctx_types[a] += 1
    def bow(w):
        if ctx_counts[w] == 0:
            return 0.0
        return math.log10(discount * ctx_types[w] / ctx_counts[w])
    lines.append(f"-99\t<s>\t{bow('<s>'):.6f}")
    for w in vocab_all:
        lines.append(f"{math.log10(p_uni[w]):.6f}\t{w}\t{bow(w):.6f}")
    lines.append("")
    lines.append("\\2-grams:")
    for (a, b), c in sorted(bi.items()):
        p = (c - discount) / ctx_counts[a]
        # interpolation mass goes through the backoff arc; keep pure discounted
        lines.append(f"{math.log10(max(p, 1e-10)):.6f}\t{a} {b}")
    lines.append("")
    lines.append("\\end\\")
    return "\n".join(lines)
